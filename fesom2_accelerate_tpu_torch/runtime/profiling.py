"""Bytes-moved models (numpy), for rates printed beside measured times.

A copy of the numpy byte models of
``fesom2_accelerate_tpu/runtime/profiling.py`` (``grid_points``,
``fct_ale_step_bytes``, ``stress2rhs_bytes``): the port cannot import the
JAX package, whose ``__init__`` imports jax.  The code is kept identical,
so both packages count the same bytes for the same mesh.  The JAX module's
table of TPU memory peaks is not carried over: a peak beside a number of
the port is the card's own, measured or from its data sheet, and named
with the card.

The reference's perf methodology is explicit per-kernel bytes models
divided by measured time (kernels/fct_ale_a1.py:93-95 and friends).
"""

from __future__ import annotations

import numpy as np

from fesom2_accelerate_tpu_torch.mesh.topology import Mesh


def fct_ale_step_bytes(mesh: Mesh, itemsize: int = 4,
                       iter_yn: bool = False) -> int:
    """Modeled memory traffic of one full a->b->c step, reference-style.

    Counts every array read/write once per stage at ``itemsize`` bytes per
    active entry (gathers counted once per incidence, like the reference's
    per-edge/per-cluster accounting in kernels/fct_ale_a3.py:116-151 and
    kernels/fct_ale_b1_horizontal.py:70-89).  Index/mask traffic (int32/bool)
    is included at 4/1 bytes.  Fused kernels can beat it only by keeping
    intermediates on chip.
    """
    L = mesh.n_layers
    nod = int(np.sum(mesh.nlev_nod - 1))  # active node-layers
    elem_active = int(np.sum(mesh.nlev_elem - 1))
    elem_full = L * mesh.n_elems  # a2 writes padded full depth
    edge = int(np.sum(mesh.nlev_edge))
    deg_e = int(np.sum(mesh.node_elems_num * (mesh.nlev_nod - 1)))
    deg_d = int(np.sum(mesh.node_edges_num * (mesh.nlev_nod - 1)))
    vint = int(np.sum(mesh.nlev_nod))  # interfaces incl. bottom
    f = itemsize

    b = 0
    # a1: read fct_LO, ttf; write tmax, tmin
    b += 4 * nod * f
    # a2: gather tmax,tmin at 3 nodes; write UV pair over full depth
    b += (2 * 3 * elem_active + 2 * elem_full) * f + 3 * 4 * mesh.n_elems
    # a3: gather UV pair over node's element cluster; read fct_LO;
    #     write tmax2, tmin2
    b += (2 * deg_e + 3 * nod) * f + 4 * deg_e // max(L - 1, 1)
    # b1v: read adf_v interfaces; write fct_plus/minus
    b += (vint + 2 * nod) * f
    # b1h: gather adf_h per node-edge incidence; read+write fct_plus/minus
    b += (deg_d + 4 * nod) * f + 4 * deg_d // max(L - 1, 1)
    # b2: read fct_plus/minus, tmax2, tmin2, area_inv; write fct_plus/minus
    b += 7 * nod * f
    # b3v: read fct_plus/minus, adf_v; write adf_v
    b += (2 * nod + 2 * vint) * f
    # b3h: gather fct_plus/minus at both edge ends; read+write adf_h
    b += (4 * edge + 2 * edge) * f + 2 * 4 * mesh.n_edges
    if iter_yn:
        # residual fluxes written in b3 + fct_LO update (read LO, hnode_new,
        # adf_v, gather adf_h; write LO)
        b += (vint + edge) * f
        b += (3 * nod + vint + deg_d + nod) * f
    else:
        # c: read ttf, hnode, LO, hnode_new, adf_v, del_v, del_h,
        #    gather adf_h; write del_v, del_h
        b += (7 * nod + vint + deg_d + 2 * nod) * f
    return b


def grid_points(mesh: Mesh) -> int:
    """Active node-layers per step — the throughput unit of the FCT step."""
    return int(np.sum(mesh.nlev_nod - 1))


def stress2rhs_bytes(mesh: Mesh, itemsize: int = 4) -> int:
    """Modeled memory traffic of one stress2rhs call (the second workload;
    reference src/reference.cpp:440-480), reference-style accounting:

    per element — 3 stress components, area+ice activity, metric factor,
    6 shape-function gradients read once (:445-462); the element->node
    scatter of the 2 (u, v) contributions at 3 corners counted once per
    incidence like the reference's per-edge models
    (kernels/fct_ale_b1_horizontal.py:70-89); per node — inv_areamass,
    rhs_a, rhs_m reads and the U/V writes (:464-476); int32 connectivity."""
    E, N = mesh.n_elems, mesh.n_nodes
    f = itemsize
    b = (3 + 1 + 1 + 6) * E * f  # element inputs
    b += 2 * 3 * E * f  # u/v contribution per corner incidence
    b += 5 * N * f  # inv_areamass, rhs_a, rhs_m reads; U, V writes
    b += 3 * 4 * E  # elem_nodes int32
    return b
