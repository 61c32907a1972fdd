"""FCT-ALE through the host ABI on every MPI rank of a partitioned run: how
FESOM2 calls the library from more than one rank.

Each rank holds its stripe of the mesh (:mod:`portbench.ranks`: the host's
own partition and exchange lists, ``ctx.world`` stripes of even size, in
FESOM2's local numbering) and sets the library up on it once
(``host_embed.setup_part``, backend 1: the CUDA kernels in float32,
``dt_milli`` from the configuration's ``dt``).  A model step is, for each
tracer in turn, ``host_embed.pre_comm`` on the tracer's eight float64
host buffers (each local edge's flux signed by its local direction,
:class:`ranks.Part` ``edge_sign``) and the rank's two factor buffers, the
host's exchange of
both factors' halo columns with the neighbouring ranks
(:func:`ranks.exchange`: gloo, CPU tensors over the numpy buffers), then
``host_embed.post_comm``, which synchronizes.  ``hnode``, ``hnode_new``
and the factor buffers are shared by the tracers.  Each tracer's buffers
carry its results to the next step.  No carried buffer needs its halo
columns refreshed between steps: the step writes none of the inputs it
reads at a halo column (``ttf``, ``fct_LO``, ``hnode``, ``hnode_new``,
non-iterative), and the owned results read what it writes (fluxes and
increments) only at owned nodes and at edges that touch one, which the
rank computes itself.

Traffic keys: ``tracers``, ``limits``.

Check: ``abi_relerr``, after every step the run took (set-up's and the
window's): rank 0 gathers every rank's owned node columns and owned edges
of the fields the step writes and compares them with the float64
whole-mesh reference that takes as many steps from the seed's fields, as
:mod:`portbench.drivers.fct_abi` does.
"""

from __future__ import annotations

import numpy as np
import torch

from fesom2_accelerate_tpu_torch import host_embed

from portbench import inputs, ranks
from portbench.drivers.fct_abi import ABI_FLUX_EPS, ORDER
from portbench.drivers.fct_resident import compared, reference
from portbench.reference import fct
from portbench.reference.compare import relerr
from portbench.reference.mesh import build_mesh


class Phases:
    # the host's exchange between the phases (a fault check turns it off)
    exchanged = True

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
            elem_nodes, nlev_elem, node_xy = inputs.planar_mesh(
                m["nx"], m["ny"], m["nl"])
            self.ref_mesh = build_mesh(elem_nodes, nlev_elem, m["nl"],
                                       node_xy)
            self.parts = ranks.stripes(
                elem_nodes, nlev_elem, node_xy, self.ref_mesh.edges,
                ranks.even_counts(self.ref_mesh.n_nodes, ctx.world))
            p = self.part = self.parts[ctx.rank]
        with ctx.phase("solver"):
            rc = host_embed.setup_part(
                len(p.elem_nodes), m["nl"], p.elem_nodes.ctypes.data,
                p.nlev_elem.ctypes.data, len(p.nodes), p.n_owned,
                p.node_xy.ctypes.data, round(self.dt * 1000), f["vlimit"],
                0, 1)
            if rc != 0:
                raise RuntimeError(f"host_embed.setup_part returned {rc}")
            want = (len(p.nodes), len(p.edges), self.ref_mesh.n_layers)
            if host_embed.dims() != want:
                raise RuntimeError(f"host_embed.dims() {host_embed.dims()}, "
                                   f"rank {ctx.rank}'s local mesh {want}")
        with ctx.phase("fields"):
            s0 = inputs.fields(self.ref_mesh, ctx.seed, self.T, dev)[0]
            nodes = torch.as_tensor(p.nodes, device=dev)
            edges = torch.as_tensor(p.edges, device=dev)
            sign = torch.as_tensor(p.edge_sign, device=dev)

            def local(k, v):
                if k == "fct_adf_h":
                    v = v.index_select(-1, edges) * sign
                else:
                    v = v.index_select(-1, nodes)
                return np.ascontiguousarray(v.cpu().numpy())

            # the host's own buffers, the rank's columns of the seed's
            shared = {k: local(k, s0[k]) for k in inputs.SHARED_FIELDS}
            self.bufs = [
                dict(shared, **{k: local(k, s0[k][t])
                                for k in inputs.TRACER_FIELDS})
                for t in range(self.T)]
            L = self.ref_mesh.n_layers
            self.factors = [np.zeros((L, len(p.nodes))) for _ in range(2)]
            self.addrs = [[b[k].ctypes.data for k in ORDER]
                          + [a.ctypes.data for a in self.factors]
                          for b in self.bufs]
            # the reference starts from the seed's fields on rank 0
            self.s0 = s0 if ctx.rank == 0 else None
            del s0
        self.steps = 0
        with ctx.phase("first_call"):
            self.step()
        self.bytes_per_step = None

    def step(self):
        for a in self.addrs:
            if host_embed.pre_comm(*a) != 0:
                raise RuntimeError("host_embed.pre_comm failed")
            if self.exchanged:
                ranks.exchange(self.part, self.factors)
            if host_embed.post_comm(*a) != 0:
                raise RuntimeError("host_embed.post_comm failed")
        self.steps += 1

    def _gathered(self) -> dict | None:
        """Every rank's owned columns and edges of the compared fields,
        placed in whole-mesh arrays [T, rows, N or Ed] on rank 0 (a
        collective over the ranks); None elsewhere."""
        p = self.part
        own = p.owned_edges
        mine = (p.rank, {k: np.stack([
            b[k][:, own] * p.edge_sign[own] if k == "fct_adf_h" else
            b[k][:, :p.n_owned] for b in self.bufs])
            for k in compared(False)})
        every = [mine]
        if self.ctx.world > 1:
            import torch.distributed as dist

            every = [None] * self.ctx.world if p.rank == 0 else None
            dist.gather_object(mine, every, dst=0)
        if p.rank != 0:
            return None
        mesh = self.ref_mesh
        out = {}
        for k in compared(False):
            n = mesh.n_edges if k == "fct_adf_h" else mesh.n_nodes
            rows = mine[1][k].shape[1]
            out[k] = np.zeros((self.T, rows, n))
            for r, got in every:
                q = self.parts[r]
                cols = (q.edges[q.owned_edges] if k == "fct_adf_h"
                        else q.nodes[:q.n_owned])
                out[k][:, :, cols] = got[k]
        return out

    def checks(self, control: bool = False) -> list:
        """[(name, value, limit)] on rank 0 ([] elsewhere); ``control``:
        the reference in bfloat16 takes the program's place."""
        host_embed.reset()
        got = self._gathered()
        if got is None:
            return []
        mk = fct.Masks(self.ref_mesh, torch.float64, self.ctx.device)
        kw = dict(dt=self.dt, flux_eps=self.flux_eps, iter_yn=False,
                  tracers=self.T)
        want = reference(mk, self.s0, self.steps, **kw)
        if self.T == 1:
            got = {k: v[0] for k, v in got.items()}
        if control:
            low = fct.Masks(self.ref_mesh, torch.bfloat16, self.ctx.device)
            got = reference(low, self.s0, self.steps, dtype=torch.bfloat16,
                            **kw)
        return [("abi_relerr", relerr(got, want), self.limits["abi_relerr"])]


def setup(ctx) -> Phases:
    return Phases(ctx)
