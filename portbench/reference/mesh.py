"""The reference's own mesh: connectivity derived from the raw element list.

A frozen copy of the derivation FESOM2's host hands the library ready-made
(``edges``, ``edge_tri``, ``nod_in_elem2D``, ``nlevels_nod2D``) and the
library derives from ``elem_nodes`` alone: numpy only, independent of the
program under test.  The edge order (sorted by first endpoint, each edge
stored low id first) is the order every edge field of the benchmark is
made and compared in, the order a host sizes its edge buffers by.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RefMesh:
    """A triangulated surface with ALE layers: 0-based int32 arrays, -1 for
    padding in the ragged incidence lists."""

    nl: int
    elem_nodes: np.ndarray  # [E, 3]
    edges: np.ndarray  # [Ed, 2], first endpoint < second
    edge_tri: np.ndarray  # [Ed, 2], right triangle -1 on the boundary
    nlev_elem: np.ndarray  # [E], interfaces of each element, in [3, nl]
    nlev_nod: np.ndarray  # [N], max over incident elements
    nlev_edge: np.ndarray  # [Ed], active layers of each edge
    node_elems: np.ndarray  # [N, KE]
    node_elems_pos: np.ndarray  # [N, KE], the node's corner in the element
    node_elems_num: np.ndarray  # [N]
    node_edges: np.ndarray  # [N, KD]
    node_edges_sign: np.ndarray  # [N, KD], +1 where the node is the start
    node_edges_num: np.ndarray  # [N]
    area: np.ndarray  # [nl, N] float64 scalar-cell area per level

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
        return self.nl - 1


def build_edges(elem_nodes: np.ndarray) -> tuple:
    """(edges, edge_tri): each undirected edge once, low endpoint first,
    sorted by (low, high); ``edge_tri[:, 0]`` the triangle on its left."""
    E = elem_nodes.shape[0]
    src = elem_nodes.ravel()
    dst = np.roll(elem_nodes, -1, axis=1).ravel()
    tri = np.repeat(np.arange(E, dtype=np.int64), 3)
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    key = lo.astype(np.int64) * (int(max(src.max(), dst.max())) + 1) + hi
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.ones(len(key_s), dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]
    first_idx = np.nonzero(first)[0]
    counts = np.diff(np.append(first_idx, len(key_s)))
    if counts.max() > 2:
        raise ValueError("non-manifold mesh: an edge borders > 2 triangles")
    edges = np.empty((len(first_idx), 2), dtype=np.int32)
    edge_tri = np.full((len(first_idx), 2), -1, dtype=np.int32)
    f = order[first_idx]
    edges[:, 0], edges[:, 1] = src[f], dst[f]
    edge_tri[:, 0] = tri[f]
    two = counts == 2
    edge_tri[two, 1] = tri[order[first_idx[two] + 1]]
    flip = edges[:, 0] > edges[:, 1]
    edges[flip] = edges[flip][:, ::-1]
    edge_tri[flip] = edge_tri[flip][:, ::-1]
    lone = edge_tri[:, 0] < 0
    edge_tri[lone] = edge_tri[lone][:, ::-1]
    return edges, edge_tri


def _padded(rows: np.ndarray, cols: np.ndarray, extra: np.ndarray,
            n_rows: int) -> tuple:
    """(row, col, extra) triples -> [n_rows, K] padded with -1, each row
    in the triples' order; and the counts."""
    order = np.argsort(rows, kind="stable")
    rows_s = rows[order]
    counts = np.bincount(rows_s, minlength=n_rows).astype(np.int32)
    offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    slot = np.arange(len(rows_s)) - offsets[rows_s]
    K = int(counts.max())
    out = np.full((n_rows, K), -1, dtype=np.int32)
    out_x = np.full((n_rows, K), -1, dtype=extra.dtype)
    out[rows_s, slot] = cols[order]
    out_x[rows_s, slot] = extra[order]
    return out, out_x, counts


def build_mesh(elem_nodes, nlev_elem, nl: int, node_xy) -> RefMesh:
    """The mesh of elements ``elem_nodes`` [E, 3] with ``nlev_elem`` [E]
    interfaces each and node coordinates ``node_xy`` [N, 2]; areas are a
    third of the incident triangles' areas, shrinking linearly to 0.85 at
    the deepest level."""
    elem_nodes = np.ascontiguousarray(elem_nodes, dtype=np.int32)
    nlev_elem = np.ascontiguousarray(nlev_elem, dtype=np.int32)
    E = elem_nodes.shape[0]
    N = int(elem_nodes.max()) + 1
    edges, edge_tri = build_edges(elem_nodes)
    rows = elem_nodes.ravel()
    cols = np.repeat(np.arange(E, dtype=np.int32), 3)
    node_elems, node_elems_pos, node_elems_num = _padded(
        rows, cols, np.tile(np.arange(3, dtype=np.int32), E), N)
    Ed = edges.shape[0]
    node_edges, node_edges_sign, node_edges_num = _padded(
        edges.ravel(), np.repeat(np.arange(Ed, dtype=np.int32), 2),
        np.tile(np.array([1, -1], dtype=np.int8), Ed), N)
    nlev_nod = np.zeros(N, dtype=np.int32)
    np.maximum.at(nlev_nod, rows, nlev_elem[cols])
    left = nlev_elem[edge_tri[:, 0]] - 1
    right = np.where(edge_tri[:, 1] >= 0, nlev_elem[edge_tri[:, 1]] - 1, 0)
    xy = np.asarray(node_xy, dtype=np.float64)
    p0, p1, p2 = (xy[elem_nodes[:, k]] for k in range(3))
    tri_area = 0.5 * np.abs((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
                            - (p1[:, 1] - p0[:, 1]) * (p2[:, 0] - p0[:, 0]))
    node_area = np.zeros(N)
    np.add.at(node_area, rows, np.repeat((tri_area + 1e-12) / 3.0, 3))
    area = node_area[None, :] * np.linspace(1.0, 0.85, nl)[:, None]
    return RefMesh(
        nl=int(nl), elem_nodes=elem_nodes, edges=edges, edge_tri=edge_tri,
        nlev_elem=nlev_elem, nlev_nod=nlev_nod,
        nlev_edge=np.maximum(left, right).astype(np.int32),
        node_elems=node_elems, node_elems_pos=node_elems_pos,
        node_elems_num=node_elems_num, node_edges=node_edges,
        node_edges_sign=node_edges_sign, node_edges_num=node_edges_num,
        area=area)
