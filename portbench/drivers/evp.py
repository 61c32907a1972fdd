"""The sea-ice EVP subcycles: the library's second entry point, which every
FESOM2 run with sea ice calls ``evp_rheol_steps`` times an ocean step.

The element inputs are packed once in set-up
(``Stress2RhsSolver.pack_elem_inputs``).  A substep is one
``call_packed``, then ``rhs_a + CARRY U`` into the next call, so each call
depends on the one before and reads other inputs; a model step is the
configuration's ``evp_rheol_steps`` substeps, run by
``runtime/graphs.StepGraphs.run`` (graph replays where they pay).  On a
node with mass a substep takes ``rhs_a`` to ``(1 + CARRY) rhs_a + CARRY
s``, ``s`` the node's stress term, the same through a model step: over
120 substeps ``rhs_a`` grows about 3.3 times and gains about 2.3 ``s``,
so the chain stays finite.  A model step starts from the seed's first
``rhs_a`` on even model steps and its second on odd ones, so that a model
step's U differs from the one before.

Traffic keys: ``limits``.

Check: ``s2r_relerr``, U and V of the last substep of each of the
window's last two model steps (the one before held, not copied) against
the float64 reference that follows the same chain of substeps from the
seed's inputs (as served, float32) and the step's first ``rhs_a``: a
program that stopped stepping leaves the two equal, and one of them
wrong; one that runs fewer substeps ends the chain early, off by about
``CARRY``.
"""

from __future__ import annotations

import torch

from fesom2_accelerate_tpu_torch.mesh import build_mesh_from_elements
from fesom2_accelerate_tpu_torch.model import Stress2RhsSolver
from fesom2_accelerate_tpu_torch.runtime.graphs import StepGraphs

from portbench import inputs
from portbench.reference.compare import relerr
from portbench.reference.mesh import build_mesh
from portbench.reference.stress2rhs import stress2rhs

# model steps before the window: the first chooses graphs or the loop and
# captures, the next ones capture the block lengths of later steps
WARM_CALLS = 4
# the share of U that each substep adds to the next one's rhs_a
CARRY = 1e-2
ELEM = ("elem_area", "ice_strength", "sigma11", "sigma12", "sigma22",
        "gradient_sca", "metric_factor")


def substep(solver, packed, inv_areamass, rhs_m):
    """One EVP substep as a step of the carry (rhs_a, u, v)."""
    def step(c):
        u, v = solver.call_packed(packed, inv_areamass, c["rhs_a"], rhs_m)
        return {"rhs_a": torch.add(c["rhs_a"], u, alpha=CARRY), "u": u,
                "v": v}
    return step


class Evp:
    def __init__(self, ctx):
        cfg, dev = ctx.config, ctx.device
        self.ctx = ctx
        self.n = int(cfg["evp_rheol_steps"])
        self.limits = ctx.traffic["limits"]
        m = cfg["mesh"]
        with ctx.phase("mesh"):
            elem_nodes, nlev_elem, node_xy = inputs.planar_mesh(
                m["nx"], m["ny"], m["nl"])
            self.ref_mesh = build_mesh(elem_nodes, nlev_elem, m["nl"],
                                       node_xy)
            mesh = build_mesh_from_elements(elem_nodes, nlev_elem, m["nl"],
                                            node_xy)
        with ctx.phase("fields"):
            self.x = {k: v.float() for k, v in inputs.evp_inputs(
                self.ref_mesh, ctx.seed, dev).items()}
        with ctx.phase("solver"):
            solver = Stress2RhsSolver(mesh, torch.float32, device=dev)
            packed = solver.pack_elem_inputs(*(self.x[k] for k in ELEM))
            self.graphs = StepGraphs(dev)
            self.sub = substep(solver, packed, self.x["inv_areamass"],
                               self.x["rhs_m"])
            self.calls = 0
            u = torch.zeros_like(self.x["rhs_m"])
            self.carry = {"rhs_a": self.x["rhs_a"][0], "u": u,
                          "v": torch.zeros_like(u)}
        with ctx.phase("first_call"):
            self.step()
            ctx.sync()
        with ctx.phase("warm_up"):
            for _ in range(WARM_CALLS - 1):
                self.step()
            ctx.sync()
        # a substep's 11 MB stay in the 50 MB L2 from one substep to the
        # next: a share of the HBM peak would not bound this cell
        self.bytes_per_step = None

    def step(self):
        start = dict(self.carry, rhs_a=self.x["rhs_a"][self.calls % 2])
        self.prev, self.carry = self.carry, self.graphs.run(self.sub, start,
                                                            self.n)
        self.calls += 1

    def checks(self, control: bool = False) -> list:
        """[(name, value, limit)].  ``control``: the reference in
        bfloat16 takes the program's place."""
        worst = 0.0
        for back, carry in ((2, self.prev), (1, self.carry)):
            got = {"u": carry["u"], "v": carry["v"]}
            if control:
                got = self._reference(torch.bfloat16, back)
            worst = max(worst, relerr(got, self._reference(torch.float64,
                                                           back)))
        self.graphs = self.sub = self.carry = self.prev = None
        return [("s2r_relerr", worst, self.limits["s2r_relerr"])]

    def _reference(self, dtype, back: int) -> dict:
        """U, V of the last substep of the model step ``back`` steps
        before the last one's end (1: the last), the chain of substeps
        followed in ``dtype``."""
        x = {k: v.to(dtype) for k, v in self.x.items()}
        rhs_a = x["rhs_a"][(self.calls - back) % 2]
        for _ in range(self.n):
            u, v = stress2rhs(self.ref_mesh, *(x[k] for k in ELEM),
                              x["inv_areamass"], rhs_a, x["rhs_m"])
            rhs_a = rhs_a + CARRY * u
        return {"u": u, "v": v}


def setup(ctx) -> Evp:
    return Evp(ctx)
