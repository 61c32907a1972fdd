"""FCT-ALE through the host ABI at the configuration's working precision:
:mod:`portbench.drivers.fct_abi`'s model step, buffers and check, with
``host_embed.setup`` given the backend that runs the CUDA kernels in the
configuration's ``fct.dtype`` (:data:`BACKENDS`: 2 for float64, 1 for
float32; the f32 cell's driver asks for backend 1 whatever the
configuration says).  The configuration's ``flux_eps`` has to be that
backend's (``host_embed.config``).

A model step is ``host_embed.step`` on each tracer's eight float64 host
buffers in turn, ``hnode`` and ``hnode_new`` shared, page-locked at the
first call.  ``bytes_per_step`` is the step's contract at the kernels'
itemsize (:func:`portbench.contract.fct_step_bytes`), which
``kernels_roofline.abi`` holds against the kernels' own device time.

Traffic keys: ``tracers``, ``limits``.

Check: ``abi_relerr``, the buffers after every step the run took against
the float64 reference that takes as many steps, as
:class:`~portbench.drivers.fct_abi.Abi` takes it.
"""

from __future__ import annotations

from fesom2_accelerate_tpu_torch import host_embed

from portbench import contract, inputs
from portbench.drivers import fct_abi
from portbench.drivers.fct_resident_wp import dtype_of
from portbench.reference.mesh import build_mesh

# the backend whose kernels run in each working precision
BACKENDS = {"float64": 2, "float32": 1}


class AbiWp(fct_abi.Abi):
    def __init__(self, ctx):
        cfg, dev = ctx.config, ctx.device
        self.ctx = ctx
        self.T = int(ctx.traffic["tracers"])
        self.limits = ctx.traffic["limits"]
        f = cfg["fct"]
        self.dt, self.flux_eps = f["dt"], f["flux_eps"]
        backend = BACKENDS.get(f["dtype"])
        if backend is None:
            raise ValueError(f"no ABI backend runs the kernels in "
                             f"{f['dtype']}: {sorted(BACKENDS)}")
        dt_milli = round(self.dt * 1000)
        eps = host_embed.config(backend, dt_milli, f["vlimit"], 0).flux_eps
        if self.flux_eps != eps or f["iter_yn"]:
            raise ValueError(f"the ABI's backend {backend} runs flux_eps="
                             f"{eps}, non-iterative; the configuration "
                             f"asks for {f}")
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
            self.addrs = [[b[k].ctypes.data for k in fct_abi.ORDER]
                          for b in self.bufs]
        with ctx.phase("solver"):
            rc = host_embed.setup(
                elem_nodes.shape[0], m["nl"], elem_nodes.ctypes.data,
                nlev_elem.ctypes.data, node_xy.shape[0],
                node_xy.ctypes.data, dt_milli, f["vlimit"], 0, backend)
            if rc != 0:
                raise RuntimeError(f"host_embed.setup(backend={backend}) "
                                   f"returned {rc}")
            want = (self.ref_mesh.n_nodes, self.ref_mesh.n_edges,
                    self.ref_mesh.n_layers)
            if host_embed.dims() != want:
                raise RuntimeError(f"host_embed.dims() {host_embed.dims()}, "
                                   f"the mesh's {want}")
        self.steps = 0
        with ctx.phase("first_call"):
            self.step()
        self.bytes_per_step = contract.fct_step_bytes(
            self.ref_mesh, self.T, dtype_of(f).itemsize)


def setup(ctx) -> AbiWp:
    return AbiWp(ctx)
