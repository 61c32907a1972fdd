"""FCT-ALE through the host ABI: how FESOM2 uses the library as an offload.

``host_embed.setup`` runs once on the raw mesh arrays (backend 1: the CUDA
kernels in float32, ``dt_milli`` from the configuration's ``dt``).  A model
step is ``host_embed.step`` on each tracer's eight float64 host buffers in
turn: pageable numpy arrays, as a Fortran host's are, ``hnode`` and
``hnode_new`` shared by the tracers.  Each call copies the fields in, steps
and writes the results back into the buffers, which carry them to the next
step.

Traffic keys: ``tracers``, ``limits``.

Check: ``abi_relerr``, the buffers after every step the run took (set-up's
and the window's) against the float64 reference that takes as many steps
from the seed's fields: a step costs the reference milliseconds, and the
window holds tens of them.
"""

from __future__ import annotations

import numpy as np
import torch

from fesom2_accelerate_tpu_torch import host_embed

from portbench import inputs
from portbench.drivers.fct_resident import compared, reference
from portbench.reference import fct
from portbench.reference.compare import relerr
from portbench.reference.mesh import build_mesh

# the order of host_embed.step's buffers
ORDER = ("ttf", "fct_LO", "fct_adf_v", "fct_adf_h", "hnode", "hnode_new",
         "del_ttf_advvert", "del_ttf_advhoriz")
# the flux guard of backend 1 (host_embed.config)
ABI_FLUX_EPS = 1e-7


class Abi:
    def __init__(self, ctx):
        cfg, dev = ctx.config, ctx.device
        self.ctx = ctx
        self.T = int(ctx.traffic["tracers"])
        self.limits = ctx.traffic["limits"]
        f = cfg["fct"]
        self.dt, self.flux_eps = f["dt"], f["flux_eps"]
        if self.flux_eps != ABI_FLUX_EPS or f["iter_yn"]:
            raise ValueError(f"the ABI's backend 1 runs flux_eps="
                             f"{ABI_FLUX_EPS}, non-iterative; the "
                             f"configuration asks for {f}")
        m = cfg["mesh"]
        with ctx.phase("mesh"):
            self.raw = inputs.planar_mesh(m["nx"], m["ny"], m["nl"])
            elem_nodes, nlev_elem, node_xy = self.raw
            self.ref_mesh = build_mesh(elem_nodes, nlev_elem, m["nl"],
                                       node_xy)
        with ctx.phase("fields"):
            self.s0 = inputs.fields(self.ref_mesh, ctx.seed, self.T,
                                    dev)[0]
            # the host's own buffers, never views of the seed's fields
            shared = {k: self.s0[k].cpu().numpy().copy()
                      for k in inputs.SHARED_FIELDS}
            self.bufs = [
                dict(shared, **{k: self.s0[k][t].cpu().numpy().copy()
                                for k in inputs.TRACER_FIELDS})
                for t in range(self.T)]
            self.addrs = [[b[k].ctypes.data for k in ORDER]
                          for b in self.bufs]
        with ctx.phase("solver"):
            rc = host_embed.setup(
                elem_nodes.shape[0], m["nl"], elem_nodes.ctypes.data,
                nlev_elem.ctypes.data, node_xy.shape[0],
                node_xy.ctypes.data, round(self.dt * 1000), f["vlimit"], 0,
                1)
            if rc != 0:
                raise RuntimeError(f"host_embed.setup returned {rc}")
            want = (self.ref_mesh.n_nodes, self.ref_mesh.n_edges,
                    self.ref_mesh.n_layers)
            if host_embed.dims() != want:
                raise RuntimeError(f"host_embed.dims() {host_embed.dims()}, "
                                   f"the mesh's {want}")
        self.steps = 0
        with ctx.phase("first_call"):
            self.step()
        self.bytes_per_step = None

    def step(self):
        for a in self.addrs:
            if host_embed.step(*a) != 0:
                raise RuntimeError("host_embed.step failed")
        self.steps += 1

    def checks(self, control: bool = False) -> list:
        host_embed.reset()
        mk = fct.Masks(self.ref_mesh, torch.float64, self.ctx.device)
        kw = dict(dt=self.dt, flux_eps=self.flux_eps, iter_yn=False,
                  tracers=self.T)
        want = reference(mk, self.s0, self.steps, **kw)
        if control:
            low = fct.Masks(self.ref_mesh, torch.bfloat16, self.ctx.device)
            got = reference(low, self.s0, self.steps, dtype=torch.bfloat16,
                            **kw)
        else:
            got = {k: np.stack([b[k] for b in self.bufs]) if self.T > 1
                   else self.bufs[0][k] for k in compared(False)}
        return [("abi_relerr", relerr(got, want), self.limits["abi_relerr"])]


def setup(ctx) -> Abi:
    return Abi(ctx)
