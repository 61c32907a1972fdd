"""A FESOM2 host's MPI ranks over the benchmark's mesh: its partition, in
FESOM2's local numbering, and its exchange of halo columns.

What METIS and FESOM2's ``com_nod2D`` give a real host, made here from the
mesh alone and independent of the program's partitioner
(``parallel/partition.py``), so that a change there cannot change a
cell's inputs:

* rank r owns a stripe of the lattice, the global nodes
  ``[sum(counts[:r]), sum(counts[:r+1]))`` (the planar mesh numbers its
  nodes along the shorter axis, so a range of ids is a band of columns);
* its halo is every other node of an element that touches an owned node;
* its local nodes are FESOM2's ``myDim_nod2D`` owned nodes first, then
  its ``eDim_nod2D`` halo nodes, each group in global order; its local
  elements every element that touches an owned node, in global order;
* its local edges are derived from its local elements as the library
  derives them (:func:`portbench.reference.mesh.build_edges`: each from
  its lower local id, sorted by it), the order of its edge buffers; an
  edge flux is signed by its edge's direction, so a host negates the flux
  of each local edge that runs against its global one, going in and
  coming out (``edge_sign``);
* each edge is owned by the owner of its lower global endpoint, so every
  edge is owned once, by a rank that holds both its triangles;
* between two ranks, the nodes one owns that the other holds in its halo,
  in global order, as local columns on both sides.

:func:`exchange` is the host's ``exchange_nod``: the halo columns of host
arrays overwritten with their owners' values, over ``torch.distributed``
on CPU tensors that wrap the arrays, as FESOM2's MPI works on host memory.
The partition is numpy only and imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.mesh import build_edges


@dataclasses.dataclass
class Part:
    """One rank's share: ``nodes`` [n_local] the global id of each local
    node (the owned ``n_owned`` first); ``elem_nodes`` [E_loc, 3] int32
    local ids, ``nlev_elem`` [E_loc] int32 and ``node_xy`` [n_local, 2]
    f64, the arrays the host passes to the library; ``edges`` [Ed_loc] the
    global id of each local edge, ``edge_sign`` [Ed_loc] +1 where it runs
    as the global edge, -1 against it; ``owned_edges`` the local ids of the
    edges this rank owns; ``sends`` / ``recvs``: neighbour rank -> the
    local columns sent to it (owned) and received from it (halo)."""

    rank: int
    nodes: np.ndarray
    n_owned: int
    elem_nodes: np.ndarray
    nlev_elem: np.ndarray
    node_xy: np.ndarray
    edges: np.ndarray
    edge_sign: np.ndarray
    owned_edges: np.ndarray
    sends: dict
    recvs: dict


def even_counts(n_nodes: int, ranks: int) -> np.ndarray:
    """Owned nodes a rank, as even as they go, the larger shares first."""
    return np.array([len(a) for a in np.array_split(np.arange(n_nodes),
                                                     ranks)])


def stripes(elem_nodes: np.ndarray, nlev_elem: np.ndarray,
            node_xy: np.ndarray, edges: np.ndarray,
            counts: np.ndarray) -> list:
    """Every rank's :class:`Part` of the mesh of ``elem_nodes`` [E, 3],
    whose edges (global ids, lower first, sorted) are ``edges`` [Ed, 2],
    rank r owning ``counts[r]`` consecutive nodes.  Raises where a rank's
    local edges are not edges of the mesh, or the owned nodes and edges do
    not cover it once."""
    n_nodes = node_xy.shape[0]
    if int(np.sum(counts)) != n_nodes:
        raise ValueError(f"counts {list(counts)} sum to {np.sum(counts)}, "
                         f"the mesh has {n_nodes} nodes")
    owner = np.repeat(np.arange(len(counts)), counts)
    key = edges[:, 0].astype(np.int64) * n_nodes + edges[:, 1]
    parts, g2ls = [], []
    for r in range(len(counts)):
        elems = np.nonzero((owner[elem_nodes] == r).any(axis=1))[0]
        owned = np.nonzero(owner == r)[0]
        halo = np.setdiff1d(np.unique(elem_nodes[elems]), owned)
        nodes = np.concatenate([owned, halo])
        g2l = np.full(n_nodes, -1, dtype=np.int64)
        g2l[nodes] = np.arange(len(nodes))
        g2ls.append(g2l)
        local = g2l[elem_nodes[elems]].astype(np.int32)
        ends = nodes[build_edges(local)[0]]
        lo, hi = ends.min(axis=1), ends.max(axis=1)
        want = lo.astype(np.int64) * n_nodes + hi
        ids = np.minimum(np.searchsorted(key, want), len(key) - 1)
        if not np.array_equal(key[ids], want):
            raise ValueError(f"rank {r}: a local edge is not an edge of "
                             f"the mesh")
        parts.append(Part(
            r, nodes, len(owned), local,
            np.ascontiguousarray(nlev_elem[elems], dtype=np.int32),
            np.ascontiguousarray(node_xy[nodes], dtype=np.float64), ids,
            np.where(ends[:, 0] < ends[:, 1], 1.0, -1.0),
            np.nonzero(owner[lo] == r)[0], {}, {}))
    for p in parts:
        for q in parts:
            held = q.nodes[q.n_owned:]
            mine = held[owner[held] == p.rank]
            if q is not p and len(mine):
                p.sends[q.rank] = g2ls[p.rank][mine]
                q.recvs[p.rank] = g2ls[q.rank][mine]
    covered = np.concatenate([p.edges[p.owned_edges] for p in parts])
    if not np.array_equal(np.sort(covered), np.arange(len(edges))):
        raise ValueError("the ranks' owned edges do not cover the mesh "
                         "once")
    return parts


def exchange(part: Part, fields: list) -> None:
    """The host's ``exchange_nod`` of ``fields`` (f64 arrays [L, n_local]
    of ``part``'s rank), in place: each neighbour sent the owned columns
    it holds in its halo, and each halo column overwritten with its
    owner's value, every field in one message a neighbour, over the
    default ``torch.distributed`` group: every receive posted, then every
    send, then a wait for all (MPI's Irecv, Isend, Waitall)."""
    import torch
    import torch.distributed as dist

    got = [(cols, torch.empty((len(fields), fields[0].shape[0], len(cols)),
                              dtype=torch.float64))
           for cols in part.recvs.values()]
    reqs = [dist.irecv(buf, q) for q, (_, buf) in zip(part.recvs, got)]
    reqs += [dist.isend(torch.from_numpy(np.ascontiguousarray(
        np.stack([f[:, cols] for f in fields]))), q)
        for q, cols in part.sends.items()]
    for req in reqs:
        req.wait()
    for cols, buf in got:
        for f, v in zip(fields, buf.numpy()):
            f[:, cols] = v
