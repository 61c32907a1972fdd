"""Mesh topology: connectivity derived from the element list (numpy).

A copy of ``fesom2_accelerate_tpu/mesh/topology.py`` (``Mesh``,
``build_mesh_from_elements``): the port cannot import the JAX package, whose
``__init__`` imports jax.  The code is kept identical so that both packages
derive the same connectivity from the same elements.

The reference receives its connectivity ready-made from host FESOM2 as
1-based Fortran arrays (``transfer_mesh_``, reference
src/fesom2-accelerate.cu:114-127): ``elem2D_nodes``, ``nod_in_elem2D`` (+num,
dim), ``edges``, ``edge_tri``, ``nlevels_nod2D``, ``nlevels_elem2D``.  This
module *derives* all of that, 0-based, from just ``elem_nodes`` and
per-element level counts — plus the transposed incidence structures that turn
every scatter in the algorithm into a gather:

* ``node_elems``/``node_elems_pos``: for each node, the incident elements and
  the node's local position (0..2) inside each — used by stage a3's cluster
  reduction (reference kernels/fct_ale_a3.cu:9-24) and by stress2rhs.
* ``node_edges``/``node_edges_sign``: for each node, the incident edges and
  the sign with which an edge flux contributes to the node (+1 when the node
  is the edge's first endpoint).  This replaces the reference's atomicAdd
  edge->node scatter (kernels/fct_ale_b1_horizontal.cu:24-27) with a
  deterministic gather + masked sum.

Level-count convention (FESOM): ``nlev_elem[e]`` in [3, nl] is the number of
vertical interfaces at element e; active layers are ``nlev - 1``.
``nlev_nod[n] = max over incident elements`` which guarantees every edge/elem
scatter lands inside the node's active region (the invariant the Fortran
relies on at docs/refactoring.md:180-185).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    """Unstructured triangular surface mesh with ALE vertical layers.

    All arrays are numpy, 0-based.  ``-1`` marks a missing right triangle in
    ``edge_tri`` (reference uses ``<= 0`` on 1-based indices,
    src/reference.cpp:411-413) and padding in the ragged incidence lists.
    """

    nl: int  # max number of vertical levels (interfaces); active layers = nl-1

    # core connectivity
    elem_nodes: np.ndarray  # [E, 3] int32
    edges: np.ndarray  # [Ed, 2] int32 (n1, n2)
    edge_tri: np.ndarray  # [Ed, 2] int32 (left elem, right elem or -1)

    # vertical extents
    nlev_elem: np.ndarray  # [E] int32, in [3, nl]
    nlev_nod: np.ndarray  # [N] int32 = max over incident elements
    nlev_edge: np.ndarray  # [Ed] int32 active layers = max(nl1, nl2) per edge

    # transposed incidences (ragged, padded with -1)
    node_elems: np.ndarray  # [N, KE] int32
    node_elems_pos: np.ndarray  # [N, KE] int32 local position of node in elem
    node_elems_num: np.ndarray  # [N] int32
    node_edges: np.ndarray  # [N, KD] int32
    node_edges_sign: np.ndarray  # [N, KD] int8 (+1 start, -1 end)
    node_edges_num: np.ndarray  # [N] int32

    # geometry
    node_xy: np.ndarray  # [N, 2] float64 (for partitioning / debugging)
    area: np.ndarray  # [nl, N] float64 scalar-cell area per level
    area_inv: np.ndarray  # [nl, N] float64 = 1 / area

    @property
    def n_nodes(self) -> int:
        return int(self.nlev_nod.shape[0])

    @property
    def n_elems(self) -> int:
        return int(self.elem_nodes.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def n_layers(self) -> int:
        """Active tracer layers (the reference's maxLevels = nl - 1)."""
        return self.nl - 1

    def validate(self) -> None:
        """Cheap structural invariants; raises AssertionError on violation."""
        E, Ed, N = self.n_elems, self.n_edges, self.n_nodes
        assert self.elem_nodes.shape == (E, 3)
        assert self.edges.shape == (Ed, 2)
        assert self.edge_tri.shape == (Ed, 2)
        assert self.elem_nodes.min() >= 0 and self.elem_nodes.max() < N
        assert self.edges.min() >= 0 and self.edges.max() < N
        assert self.edge_tri[:, 0].min() >= 0, "left triangle must exist"
        assert (self.nlev_elem >= 3).all() and (self.nlev_elem <= self.nl).all()
        # node level = max over incident elements (FESOM invariant)
        for k in range(self.node_elems.shape[1]):
            m = self.node_elems[:, k] >= 0
            assert (
                self.nlev_nod[m] >= self.nlev_elem[self.node_elems[m, k]]
            ).all()
        # edge level bound stays within both endpoints' active regions
        assert (self.nlev_edge <= self.nlev_nod[self.edges[:, 0]] - 1).all()
        assert (self.nlev_edge <= self.nlev_nod[self.edges[:, 1]] - 1).all()
        assert (self.area > 0).all()


def _build_edges(elem_nodes: np.ndarray):
    """Derive the edge list and edge->triangle adjacency.

    Each undirected edge appears in 1 (boundary) or 2 (interior) triangles.
    Orientation convention: the edge's node order is taken from the first
    (left) triangle's winding; the triangle on the left is the one that
    contains the edge as a forward-directed pair.
    """
    E = elem_nodes.shape[0]
    # directed half-edges per triangle: (a,b), (b,c), (c,a)
    ha = elem_nodes
    hb = np.roll(elem_nodes, -1, axis=1)
    src = ha.ravel()
    dst = hb.ravel()
    tri = np.repeat(np.arange(E, dtype=np.int64), 3)

    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = lo.astype(np.int64) * (int(max(src.max(), dst.max())) + 1) + hi
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_mask = np.ones(len(key_s), dtype=bool)
    uniq_mask[1:] = key_s[1:] != key_s[:-1]
    first_idx = np.nonzero(uniq_mask)[0]
    n_edges = len(first_idx)
    counts = np.diff(np.append(first_idx, len(key_s)))
    if counts.max() > 2:
        raise ValueError("non-manifold mesh: an edge borders > 2 triangles")

    edges = np.empty((n_edges, 2), dtype=np.int32)
    edge_tri = np.full((n_edges, 2), -1, dtype=np.int32)
    # first (left) occurrence defines the initial orientation
    f = order[first_idx]
    edges[:, 0] = src[f]
    edges[:, 1] = dst[f]
    edge_tri[:, 0] = tri[f]
    has_second = counts == 2
    s = order[first_idx[has_second] + 1]
    edge_tri[has_second, 1] = tri[s]
    # canonical orientation: n0 < n1, swapping the left/right triangles for
    # flipped edges so edge_tri[:, 0] stays the left triangle of the stored
    # direction.  With edges also sorted by min endpoint, the edges STARTING
    # in any node range are then index-contiguous, and each edge has exactly
    # one endpoint with sign +1 (its first), which the CUDA K34 kernel uses
    # to write each limited edge flux once.
    flip = edges[:, 0] > edges[:, 1]
    edges[flip] = edges[flip][:, ::-1]
    edge_tri[flip] = edge_tri[flip][:, ::-1]
    # flipped boundary edges: keep their single triangle in slot 0 (slot 1 is
    # the boundary marker -1; FCT-ALE only uses edge_tri symmetrically)
    fixup = edge_tri[:, 0] < 0
    edge_tri[fixup] = edge_tri[fixup][:, ::-1]
    return edges, edge_tri


def _ragged_to_padded(rows: np.ndarray, cols: np.ndarray, n_rows: int,
                      extra: np.ndarray | None = None):
    """Convert (row, col) pairs into a dense padded [n_rows, K] array.

    Returns (padded_cols, counts[, padded_extra]); padding value is -1.
    Deterministic: entries within a row keep ascending ``cols``-insertion
    order (sorted by (row, original position))."""
    order = np.argsort(rows, kind="stable")
    rows_s = rows[order]
    counts = np.bincount(rows_s, minlength=n_rows).astype(np.int32)
    K = int(counts.max()) if len(counts) else 0
    offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    slot = np.arange(len(rows_s)) - offsets[rows_s]
    padded = np.full((n_rows, K), -1, dtype=np.int32)
    padded[rows_s, slot] = cols[order]
    if extra is not None:
        padded_extra = np.full((n_rows, K), -1, dtype=extra.dtype)
        padded_extra[rows_s, slot] = extra[order]
        return padded, counts, padded_extra
    return padded, counts


def build_mesh_from_elements(
    elem_nodes: np.ndarray,
    nlev_elem: np.ndarray,
    nl: int,
    node_xy: np.ndarray,
    area: np.ndarray | None = None,
) -> Mesh:
    """Build the full Mesh (edges, incidences, level bounds) from elements."""
    elem_nodes = np.ascontiguousarray(elem_nodes, dtype=np.int32)
    nlev_elem = np.ascontiguousarray(nlev_elem, dtype=np.int32)
    E = elem_nodes.shape[0]
    N = int(elem_nodes.max()) + 1

    edges, edge_tri = _build_edges(elem_nodes)

    # node -> incident elements, with local position
    rows = elem_nodes.ravel()
    cols = np.repeat(np.arange(E, dtype=np.int32), 3)
    pos = np.tile(np.arange(3, dtype=np.int32), E)
    node_elems, node_elems_num, node_elems_pos = _ragged_to_padded(
        rows, cols, N, extra=pos
    )

    # node -> incident edges, with sign
    Ed = edges.shape[0]
    erows = edges.ravel()
    ecols = np.repeat(np.arange(Ed, dtype=np.int32), 2)
    esign = np.tile(np.array([1, -1], dtype=np.int8), Ed)
    node_edges, node_edges_num, node_edges_sign = _ragged_to_padded(
        erows, ecols, N, extra=esign
    )

    # vertical extents
    nlev_nod = np.zeros(N, dtype=np.int32)
    np.maximum.at(nlev_nod, rows, nlev_elem[cols])
    nl1 = nlev_elem[edge_tri[:, 0]] - 1
    nl2 = np.where(edge_tri[:, 1] >= 0, nlev_elem[edge_tri[:, 1]] - 1, 0)
    nlev_edge = np.maximum(nl1, nl2).astype(np.int32)

    if area is None:
        # simple synthetic scalar-cell areas: one third of incident element
        # areas, slightly shrinking with depth (ALE-like), always positive
        elem_area = _triangle_areas(node_xy, elem_nodes)
        node_area = np.zeros(N)
        np.add.at(node_area, rows, np.repeat(elem_area / 3.0, 3))
        depth_shrink = np.linspace(1.0, 0.85, nl)[:, None]
        area = node_area[None, :] * depth_shrink
    area = np.ascontiguousarray(area, dtype=np.float64)
    assert area.shape == (nl, N)

    mesh = Mesh(
        nl=int(nl),
        elem_nodes=elem_nodes,
        edges=edges,
        edge_tri=edge_tri,
        nlev_elem=nlev_elem,
        nlev_nod=nlev_nod,
        nlev_edge=nlev_edge,
        node_elems=node_elems,
        node_elems_pos=node_elems_pos,
        node_elems_num=node_elems_num,
        node_edges=node_edges,
        node_edges_sign=node_edges_sign,
        node_edges_num=node_edges_num,
        node_xy=np.ascontiguousarray(node_xy, dtype=np.float64),
        area=area,
        area_inv=1.0 / area,
    )
    return mesh


def _triangle_areas(node_xy: np.ndarray, elem_nodes: np.ndarray) -> np.ndarray:
    p0 = node_xy[elem_nodes[:, 0]]
    p1 = node_xy[elem_nodes[:, 1]]
    p2 = node_xy[elem_nodes[:, 2]]
    cross = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (
        p1[:, 1] - p0[:, 1]
    ) * (p2[:, 0] - p0[:, 0])
    return 0.5 * np.abs(cross) + 1e-12
