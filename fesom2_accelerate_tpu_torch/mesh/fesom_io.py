"""FESOM2 mesh-file ingestion (nod2d.out / elem2d.out / aux3d.out).

A copy of ``fesom2_accelerate_tpu/mesh/fesom_io.py`` (``read_fesom_mesh``,
``write_fesom_mesh``, ``_read_table``): the port cannot import the JAX
package, whose ``__init__`` imports jax.  The code is kept identical, so
both packages build the same mesh from the same files; the tests hold the
port to that.  Standard FESOM2 ASCII layout:

* ``nod2d.out``  — line 0: N; then ``id lon lat flag`` per node (1-based
  ids; flag 1 marks boundary nodes, unused here);
* ``elem2d.out`` — line 0: E; then 3 white-space-separated 1-based node
  ids per triangle;
* ``aux3d.out``  — line 0: nl (number of vertical levels / interfaces);
  then nl standard depths ``zbar`` (non-positive, decreasing); then
  optionally N node bottom depths (used to derive per-node level counts).

Per-ELEMENT level counts (what the FCT chain needs, reference
``nlevels_elem2D``) are derived as FESOM2 does: the element bottom is the
SHALLOWEST of its three nodes' bottoms (ocean columns can't be deeper than
any corner), clamped to >= 3 levels.

Real meshes arrive in arbitrary node order; :func:`read_fesom_mesh`
RCM-renumbers them by default
(:func:`fesom2_accelerate_tpu_torch.mesh.ordering.reorder_mesh`), as the
JAX package does, so both packages compute on the same numbering.
"""

from __future__ import annotations

import os

import numpy as np

from fesom2_accelerate_tpu_torch.mesh.topology import (
    Mesh,
    build_mesh_from_elements,
)


def read_fesom_mesh(path: str, reorder: bool = True,
                    nl_default: int = 48):
    """Read a FESOM2 mesh directory -> (Mesh, node_perm | None).

    ``node_perm[new] = old`` when ``reorder`` (RCM) is applied, else None —
    use it to permute externally supplied node fields."""
    nod = _read_table(os.path.join(path, "nod2d.out"))
    n_nodes = int(nod[0][0])
    rows = np.asarray([r[:4] for r in nod[1:1 + n_nodes]], dtype=np.float64)
    ids = rows[:, 0].astype(np.int64)
    order = np.argsort(ids, kind="stable")  # ids are 1..N but be tolerant
    node_xy = rows[order][:, 1:3]

    ele = _read_table(os.path.join(path, "elem2d.out"))
    n_elems = int(ele[0][0])
    elem_nodes = np.asarray([r[:3] for r in ele[1:1 + n_elems]],
                            dtype=np.int64) - 1  # 1-based -> 0-based
    if elem_nodes.min() < 0 or elem_nodes.max() >= n_nodes:
        raise ValueError("elem2d.out indices out of range")

    aux_path = os.path.join(path, "aux3d.out")
    if os.path.exists(aux_path):
        aux = _read_table(aux_path)
        flat = [v for r in aux for v in r]
        nl = int(flat[0])
        zbar = np.asarray(flat[1:1 + nl], dtype=np.float64)
        rest = np.asarray(flat[1 + nl:], dtype=np.float64)
        if len(rest) >= n_nodes:
            node_depth = rest[:n_nodes]
            # depths may be signed either way; use magnitude
            nd = np.abs(node_depth)
            zb = np.abs(zbar)
            # node level count: interfaces at or above the node bottom
            nlev_nod = np.searchsorted(zb, nd, side="right")
            nlev_nod = np.clip(nlev_nod, 3, nl).astype(np.int32)
        else:
            nlev_nod = np.full(n_nodes, nl, dtype=np.int32)
    else:
        nl = nl_default
        nlev_nod = np.full(n_nodes, nl, dtype=np.int32)

    # element level = min over its nodes (shallowest corner), FESOM2's
    # nlevels_elem2D derivation; >= 3 like the generator
    nlev_elem = nlev_nod[elem_nodes].min(axis=1).astype(np.int32)
    nlev_elem = np.clip(nlev_elem, 3, nl)

    mesh = build_mesh_from_elements(
        elem_nodes.astype(np.int32), nlev_elem, nl, node_xy
    )
    if not reorder:
        return mesh, None
    from fesom2_accelerate_tpu_torch.mesh.ordering import reorder_mesh

    new_mesh, perm = reorder_mesh(mesh)
    return new_mesh, perm


def write_fesom_mesh(path: str, mesh: Mesh,
                     zbar: "np.ndarray | None" = None) -> None:
    """Write a Mesh in FESOM2 ASCII layout (round-trip / export support).

    Per-node bottom depths are synthesized from ``nlev_nod`` against
    ``zbar`` (default: unit-spaced levels), so a read-back reproduces the
    level structure exactly."""
    os.makedirs(path, exist_ok=True)
    N, E, nl = mesh.n_nodes, mesh.n_elems, mesh.nl
    if zbar is None:
        zbar = -np.arange(nl, dtype=np.float64)
    assert len(zbar) == nl
    with open(os.path.join(path, "nod2d.out"), "w") as f:
        f.write(f"{N}\n")
        for i in range(N):
            x, y = mesh.node_xy[i]
            f.write(f"{i + 1} {x:.8f} {y:.8f} 0\n")
    with open(os.path.join(path, "elem2d.out"), "w") as f:
        f.write(f"{E}\n")
        for tri in mesh.elem_nodes + 1:
            f.write(f"{tri[0]} {tri[1]} {tri[2]}\n")
    with open(os.path.join(path, "aux3d.out"), "w") as f:
        f.write(f"{nl}\n")
        for z in zbar:
            f.write(f"{z:.6f}\n")
        zb = np.abs(zbar)
        for i in range(N):
            # depth of the node's last interface -> searchsorted-right
            # recovers nlev_nod exactly
            f.write(f"{-zb[mesh.nlev_nod[i] - 1]:.6f}\n")


def _read_table(path):
    """Whitespace/comma-separated numeric rows; comment lines (leading
    ``#``/``%``/``!``, a quirk of hand-edited mesh files in the wild) and
    blank lines are skipped; CRLF tolerated."""
    rows = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s[0] in "#%!":
                continue
            parts = s.replace(",", " ").split()
            rows.append([float(p) for p in parts])
    return rows
