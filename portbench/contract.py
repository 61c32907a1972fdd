"""The bytes a step's contract moves, and the peak they are held against.

A step's contract is what the host hands the library and reads back: each
input the step needs counted once where it is needed, each output written
once, at the served itemsize, from the mesh's sizes and active levels and,
where the work depends on the data, from the inputs.  Intermediates,
re-reads and the program's own layouts count for nothing, so the count is
the same whatever kernels, forms or fusions implement the step, and the
share of the peak it gives cannot pass 100% unless the time leaves out
work.
"""

from __future__ import annotations

from portbench.reference.mesh import RefMesh

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12


def fct_step_bytes(mesh: RefMesh, tracers: int, itemsize: int = 4,
                   iter_yn: bool = False) -> int:
    """One FCT-ALE step of ``tracers`` tracers.  A node field counts on
    its active node-layers (``nlev_nod - 1`` a node; the vertical fluxes
    are limited on as many interfaces), an edge field on its active
    edge-layers.  Shared by the tracers: ``hnode`` (non-iterative only),
    ``hnode_new`` and the cell areas on the active node-layers, the edges'
    endpoints and levels and the nodes' levels (int32).  A tracer's
    non-iterative step reads ``ttf``, ``fct_LO``, both fluxes and both
    increments and writes both limited fluxes and both increments; an
    iterative one reads ``ttf``, ``fct_LO`` and both fluxes and writes
    ``fct_LO`` and both remainders."""
    nod = int((mesh.nlev_nod - 1).sum())
    edge = int(mesh.nlev_edge.sum())
    conn = 12 * mesh.n_edges + 4 * mesh.n_nodes
    if iter_yn:
        shared, reads, writes = 2 * nod, 3 * nod + edge, 2 * nod + edge
    else:
        shared, reads, writes = 3 * nod, 5 * nod + edge, 3 * nod + edge
    return conn + itemsize * (shared + tracers * (reads + writes))
