"""Every input of a run, made from the seed: the mesh as raw arrays, the
tracer fields and the EVP inputs.

The mesh is the planar stand-in for a FESOM2 mesh: a structured lattice
split into triangles along alternating diagonals (node degrees 4 to 8),
nodes numbered along the shorter axis, elements ordered by their lowest
node, and a smooth synthetic bathymetry of 3 to ``nl`` interfaces an
element, shallower at the coast.  It takes no seed: every seed runs the
same mesh, so every seed runs the same work.

The fields are made on the device by one ``torch.Generator`` seeded with
the run's seed, one call a field for all tracers, in float64: standard
normal ``ttf``, ``fct_LO``, fluxes (zero outside each node's interfaces
above its bottom and each edge's layers) and increments (scaled by 0.01),
``hnode`` and ``hnode_new`` ``|x| + 0.5``, shared by the tracers.  Where
model steps take several sets in turn, each later set draws the fluxes and
increments (``STEP_FIELDS``) anew from the same generator, as FESOM2's
advection hands the limiter new unlimited fluxes every timestep.  The EVP
inputs are drawn the same way: element areas ``|x| + 0.1``, the rest
standard normal, so about half the elements carry no ice and half the
nodes no mass; two ``rhs_a``, which model steps take in turn.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.mesh import RefMesh

# fields with a tracer axis, and those the tracers share
TRACER_FIELDS = ("ttf", "fct_LO", "fct_adf_v", "fct_adf_h",
                 "del_ttf_advvert", "del_ttf_advhoriz")
SHARED_FIELDS = ("hnode", "hnode_new")
# the tracer fields a host gives anew every step: unlimited fluxes and the
# increments they are added to
STEP_FIELDS = ("fct_adf_v", "fct_adf_h", "del_ttf_advvert",
               "del_ttf_advhoriz")


def planar_mesh(nx: int, ny: int, nl: int) -> tuple:
    """(elem_nodes [E, 3] int32, nlev_elem [E] int32, node_xy [N, 2]
    float64) of the ``nx`` x ``ny`` lattice with ``nl`` levels."""
    if nx <= ny:
        node_id = np.arange(nx * ny, dtype=np.int32).reshape(ny, nx)
    else:
        node_id = np.arange(nx * ny, dtype=np.int32).reshape(nx, ny).T
    xs, ys = np.meshgrid(np.arange(nx, dtype=np.float64),
                         np.arange(ny, dtype=np.float64))
    node_xy = np.empty((nx * ny, 2), dtype=np.float64)
    node_xy[node_id.ravel()] = np.stack([xs.ravel(), ys.ravel()], axis=1)
    J, I = np.meshgrid(np.arange(ny - 1), np.arange(nx - 1), indexing="ij")
    J, I = J.ravel(), I.ravel()
    a, b = node_id[J, I], node_id[J, I + 1]
    c, d = node_id[J + 1, I], node_id[J + 1, I + 1]
    even = ((I + J) % 2 == 0)[:, None]
    first = np.where(even, np.stack([a, b, d], 1), np.stack([a, b, c], 1))
    second = np.where(even, np.stack([a, d, c], 1), np.stack([b, d, c], 1))
    elem_nodes = np.stack([first, second], 1).reshape(-1, 3).astype(np.int32)
    elem_nodes = elem_nodes[np.argsort(elem_nodes.min(axis=1),
                                       kind="stable")]
    cx = node_xy[:, 0][elem_nodes].mean(axis=1) / max(nx - 1, 1)
    cy = node_xy[:, 1][elem_nodes].mean(axis=1) / max(ny - 1, 1)
    depth = np.clip(0.55 + 0.45 * np.sin(np.pi * cx) * np.sin(np.pi * cy)
                    + 0.15 * np.sin(3.1 * np.pi * cx + 1.0)
                    * np.cos(2.3 * np.pi * cy), 0.0, 1.0)
    nlev_elem = np.clip((3 + np.round(depth * (nl - 3))).astype(np.int32),
                        3, nl)
    return elem_nodes, nlev_elem, node_xy


def fields(mesh: RefMesh, seed: int, tracers: int, device,
           sets: int = 1) -> list:
    """``sets`` dicts of float64 tensors on ``device``: each of
    TRACER_FIELDS [T, ...], SHARED_FIELDS [L, N].  The sets share all but
    STEP_FIELDS, which each later set draws anew after the first set."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    L, N, Ed = mesh.n_layers, mesh.n_nodes, mesh.n_edges

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float64)

    nlev_nod = torch.as_tensor(mesh.nlev_nod, device=device)
    nlev_edge = torch.as_tensor(mesh.nlev_edge, device=device)
    z = torch.arange(L + 1, device=device)[:, None]
    T = tracers

    def fluxes():
        return dict(fct_adf_v=draw(T, L + 1, N) * (z < nlev_nod[None] - 1),
                    fct_adf_h=draw(T, L, Ed) * (z[:L] < nlev_edge[None]))

    def increments():
        return dict(del_ttf_advvert=draw(T, L, N) * 0.01,
                    del_ttf_advhoriz=draw(T, L, N) * 0.01)

    first = dict(hnode=draw(L, N).abs() + 0.5,
                 hnode_new=draw(L, N).abs() + 0.5)
    first.update(ttf=draw(T, L, N), fct_LO=draw(T, L, N))
    first.update(fluxes())
    first.update(increments())
    return [first] + [dict(first, **fluxes(), **increments())
                      for _ in range(sets - 1)]


def evp_inputs(mesh: RefMesh, seed: int, device) -> dict:
    """float64 tensors on ``device``: ``elem_area``, ``ice_strength``,
    ``sigma11``, ``sigma12``, ``sigma22``, ``metric_factor`` [E],
    ``gradient_sca`` [6, E], ``inv_areamass``, ``rhs_m`` [N] and
    ``rhs_a`` [2, N]."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    E, N = mesh.n_elems, mesh.n_nodes
    e = torch.randn((12, E), generator=g, device=device, dtype=torch.float64)
    n = torch.randn((4, N), generator=g, device=device, dtype=torch.float64)
    return dict(elem_area=e[0].abs() + 0.1, ice_strength=e[1],
                sigma11=e[2], sigma12=e[3], sigma22=e[4],
                gradient_sca=e[5:11], metric_factor=e[11],
                inv_areamass=n[0], rhs_m=n[1], rhs_a=n[2:])
