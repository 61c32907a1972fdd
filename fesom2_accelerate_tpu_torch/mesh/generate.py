"""Synthetic mesh and field generators (numpy).

A copy of ``fesom2_accelerate_tpu/mesh/generate.py`` (``PRESETS``,
``generate_planar_mesh``, ``generate_cylinder_mesh``, ``random_fields``):
the port cannot import the JAX
package, whose ``__init__`` imports jax.  The code is kept identical, so both
packages build the same mesh and the same fields from the same arguments
and seed; the tests hold the port to that.

Presets are planar triangulations (a structured grid split into triangles)
with a smooth synthetic bathymetry for per-element level counts:

* toy, tiny, small: test sizes;
* pi:     ~3k surface nodes x 48 levels (FESOM pi mesh scale);
* core2:  ~127k surface nodes x 48 levels (global CORE2 scale).
"""

from __future__ import annotations

import numpy as np

from fesom2_accelerate_tpu_torch.mesh.topology import (
    Mesh,
    build_mesh_from_elements,
)

PRESETS = {
    "toy": dict(nx=5, ny=4, nl=5),
    "tiny": dict(nx=8, ny=6, nl=9),
    "small": dict(nx=24, ny=16, nl=24),
    "pi": dict(nx=64, ny=48, nl=48),  # 3072 nodes
    "core2": dict(nx=420, ny=303, nl=48),  # 127260 nodes
}


def generate_planar_mesh(
    nx: int | None = None,
    ny: int | None = None,
    nl: int | None = None,
    preset: str | None = None,
    seed: int = 0,
) -> Mesh:
    """Structured-grid triangulation of an nx x ny node lattice.

    Each quad is split along alternating diagonals (union-jack-like) so node
    degrees vary (4..8), exercising the ragged incidence paths the same way
    an unstructured ocean mesh does.
    """
    if preset is not None:
        p = PRESETS[preset]
        nx, ny, nl = p["nx"], p["ny"], p["nl"]
    assert nx is not None and ny is not None and nl is not None
    assert nx >= 2 and ny >= 2 and nl >= 4

    # number nodes along the SHORTER grid axis: edge-neighbours then lie at
    # most min(nx, ny) + 1 indices apart, which keeps the gathers over
    # incident edges local in memory
    if nx <= ny:
        node_id = np.arange(nx * ny, dtype=np.int32).reshape(ny, nx)
    else:
        node_id = np.arange(nx * ny, dtype=np.int32).reshape(nx, ny).T
    xs, ys = np.meshgrid(np.arange(nx, dtype=np.float64),
                         np.arange(ny, dtype=np.float64))
    node_xy = np.empty((nx * ny, 2), dtype=np.float64)
    node_xy[node_id.ravel()] = np.stack([xs.ravel(), ys.ravel()], axis=1)

    tris = []
    for j in range(ny - 1):
        for i in range(nx - 1):
            a = node_id[j, i]
            b = node_id[j, i + 1]
            c = node_id[j + 1, i]
            d = node_id[j + 1, i + 1]
            if (i + j) % 2 == 0:
                tris.append((a, b, d))
                tris.append((a, d, c))
            else:
                tris.append((a, b, c))
                tris.append((b, d, c))
    elem_nodes = np.asarray(tris, dtype=np.int32)
    # order elements by ascending min node id so element indices correlate
    # with node indices
    elem_nodes = elem_nodes[np.argsort(elem_nodes.min(axis=1),
                                       kind="stable")]

    # synthetic bathymetry: smooth 2-D bumps -> per-element level counts in
    # [3, nl]; elements near the "coast" (domain boundary) are shallower
    cx = elem_nodes_mean(node_xy[:, 0], elem_nodes) / max(nx - 1, 1)
    cy = elem_nodes_mean(node_xy[:, 1], elem_nodes) / max(ny - 1, 1)
    depth = (
        0.55
        + 0.45 * np.sin(np.pi * cx) * np.sin(np.pi * cy)
        + 0.15 * np.sin(3.1 * np.pi * cx + 1.0) * np.cos(2.3 * np.pi * cy)
    )
    depth = np.clip(depth, 0.0, 1.0)
    nlev_elem = (3 + np.round(depth * (nl - 3))).astype(np.int32)
    nlev_elem = np.clip(nlev_elem, 3, nl)

    return build_mesh_from_elements(elem_nodes, nlev_elem, nl, node_xy)


def elem_nodes_mean(values: np.ndarray, elem_nodes: np.ndarray) -> np.ndarray:
    return values[elem_nodes].mean(axis=1)


def generate_cylinder_mesh(nx: int, ny: int, nl: int,
                           reorder: bool = True):
    """Periodic-in-x (cylindrical) triangulated band — the synthetic stand-in
    for a global spherical FESOM mesh's zonal periodicity.

    The raw column-major numbering has a SEAM: elements connect column
    nx-1 back to column 0, so naive numbering has bandwidth ~N.  With
    ``reorder`` (default) the mesh is RCM-renumbered; the BFS frontier wraps
    the cycle in both directions, bounding the bandwidth at roughly twice
    the circumference.  Returns (mesh, node_perm | None)."""
    assert nx >= 3 and ny >= 2 and nl >= 4
    # RAW numbering runs along the meridians (y fastest), the order a
    # lat/lon file naturally arrives in: the x-seam then connects ids
    # ~N apart — no locality until RCM renumbers
    node_id = np.arange(nx * ny, dtype=np.int32).reshape(nx, ny).T
    xs, ys = np.meshgrid(np.arange(nx, dtype=np.float64),
                         np.arange(ny, dtype=np.float64))
    node_xy = np.empty((nx * ny, 2), dtype=np.float64)
    node_xy[node_id.ravel()] = np.stack([xs.ravel(), ys.ravel()], axis=1)

    tris = []
    for j in range(ny - 1):
        for i in range(nx):  # i == nx-1 wraps to column 0: the seam
            a = node_id[j, i]
            b = node_id[j, (i + 1) % nx]
            c = node_id[j + 1, i]
            d = node_id[j + 1, (i + 1) % nx]
            if (i + j) % 2 == 0:
                tris.append((a, b, d))
                tris.append((a, d, c))
            else:
                tris.append((a, b, c))
                tris.append((b, d, c))
    elem_nodes = np.asarray(tris, dtype=np.int32)
    cx = elem_nodes_mean(node_xy[:, 0], elem_nodes) / max(nx - 1, 1)
    cy = elem_nodes_mean(node_xy[:, 1], elem_nodes) / max(ny - 1, 1)
    depth = 0.55 + 0.45 * np.sin(2 * np.pi * cx) * np.sin(np.pi * cy)
    depth = np.clip(depth, 0.0, 1.0)
    nlev_elem = np.clip((3 + np.round(depth * (nl - 3))).astype(np.int32),
                        3, nl)
    # seam-aware areas: wrap-around triangles straddle x=0/x=nx in raw
    # coordinates, which would give bogus planar areas — unwrap x per
    # element before the area formula
    p = node_xy[elem_nodes]  # [E, 3, 2]
    x = p[:, :, 0]
    x = np.where(x - x.min(axis=1, keepdims=True) > nx / 2, x - nx, x)
    p = np.stack([x, p[:, :, 1]], axis=2)
    cross = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
             - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0]))
    elem_area = 0.5 * np.abs(cross) + 1e-12
    node_area = np.zeros(nx * ny)
    np.add.at(node_area, elem_nodes.ravel(),
              np.repeat(elem_area / 3.0, 3))
    area = node_area[None, :] * np.linspace(1.0, 0.85, nl)[:, None]

    mesh = build_mesh_from_elements(elem_nodes, nlev_elem, nl, node_xy,
                                    area=area)
    if not reorder:
        return mesh, None
    from fesom2_accelerate_tpu_torch.mesh.ordering import reorder_mesh

    return reorder_mesh(mesh)


def random_fields(mesh: Mesh, seed: int = 0, dtype=np.float64) -> dict:
    """Random input fields for one FCT-ALE step, level-major ``[nl-1|nl, X]``.

    ``ttf``/``fct_LO`` are the old tracer and low-order solution,
    ``fct_adf_v`` ([nl, N]; interface fluxes, zero from each node's bottom
    interface down, like the real model's zero bottom flux) and
    ``fct_adf_h`` ([nl-1, Ed]).  The port makes no random draws of its own:
    every input comes from here, as numpy.
    """
    rng = np.random.default_rng(seed)
    L = mesh.n_layers
    N, Ed = mesh.n_nodes, mesh.n_edges

    def f(shape):
        return rng.standard_normal(shape).astype(dtype)

    fields = dict(
        ttf=f((L, N)),
        fct_LO=f((L, N)),
        fct_adf_v=f((L + 1, N)),
        fct_adf_h=f((L, Ed)),
        hnode=np.abs(f((L, N))) + 0.5,
        hnode_new=np.abs(f((L, N))) + 0.5,
        del_ttf_advvert=f((L, N)) * 0.01,
        del_ttf_advhoriz=f((L, N)) * 0.01,
    )
    # zero vertical flux outside each node's active interface range and at the
    # bottom of the active column (the model guarantees zero bottom flux,
    # docs/refactoring.md:232)
    z = np.arange(L + 1)[:, None]
    fields["fct_adf_v"] = np.where(
        z < (mesh.nlev_nod[None, :] - 1), fields["fct_adf_v"], 0.0
    )
    # zero horizontal flux outside each edge's active layers
    zh = np.arange(L)[:, None]
    fields["fct_adf_h"] = np.where(
        zh < mesh.nlev_edge[None, :], fields["fct_adf_h"], 0.0
    )
    return fields
