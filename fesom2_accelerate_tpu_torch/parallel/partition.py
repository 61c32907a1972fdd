"""Domain decomposition with one-deep node halos (numpy).

A copy of ``fesom2_accelerate_tpu/parallel/partition.py``: the port cannot
import the JAX package, whose ``__init__`` imports jax.  The code is kept
identical apart from the ``Mesh`` it imports, so both packages partition a
mesh into equal arrays (``tests/test_torch_partition.py``).

Re-creates the distribution contract the reference inherits from
host FESOM2 (docs/refactoring.md:31,47; include/fesom2-accelerate.h myDim /
eDim node split, SURVEY §2.6):

* nodes are block-partitioned into P contiguous owned ranges (the generator's
  bandwidth-minimizing numbering is locality-preserving, so blocks are
  spatial stripes);
* each part additionally stores a one-deep **halo**: every non-owned node of
  an element touching an owned node;
* a part's **local elements** are all elements with >= 1 owned node, and its
  **local edges** all edges with >= 1 owned endpoint — so every gather needed
  to produce owned-node results is local, and shared elements/edges are
  computed redundantly (exactly the reference's redundancy choice: a1 runs on
  owned+halo nodes, src/fesom2-accelerate.cu:266, so no element exchange is
  ever needed).
* the ONLY inter-device communication per step is the exchange of
  ``fct_plus``/``fct_minus`` halo values between b2 and b3-horizontal
  (reference: host MPI ``exchange_nod``, docs/refactoring.md:199-200), plus a
  ``fct_LO`` halo refresh in iterative mode.

Local index space per part — the **[H | owned | H] layout**: columns
``[0, H)`` hold the low-side halo (right-aligned, so the halo node adjacent
to the first owned node sits at column H-1), ``[H, H+B)`` the owned block
(left-aligned), ``[H+B, H+2H)`` the high-side halo (left-aligned).  Because
a 1-D block partition of a bandwidth-ordered mesh has halos only at the two
stripe ends, this keeps local node ids ascending in global id — the index
locality the Pallas window planner requires — while the owned block sits at
the FIXED offset H on every part (static slicing in the sharded step).

All per-part arrays are padded to the maximum size across parts so the
sharded step has static shapes; padded entities carry ``nlev = 1`` (all
activity masks false) and index 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fesom2_accelerate_tpu_torch.mesh.topology import Mesh


@dataclasses.dataclass
class PartitionedMesh:
    mesh: Mesh  # the global mesh
    n_parts: int
    B: int  # padded owned block size
    H: int  # padded one-side halo size
    E_loc: int  # padded local element count
    Ed_loc: int  # padded local edge count

    owned_count: np.ndarray  # [P]
    halo_lo_count: np.ndarray  # [P]
    halo_hi_count: np.ndarray  # [P]
    local_nodes_global: np.ndarray  # [P, 2H+B] global node id (-1 pad)
    local_elems_global: np.ndarray  # [P, E_loc] (-1 pad)
    local_edges_global: np.ndarray  # [P, Ed_loc] (-1 pad)
    # owner part / in-owned-block index per halo column, one map per side
    # (low halo columns [0,H), high halo columns [H+B, H+B+H)); padding
    # positions point at the part's own owned slot 0 (harmless, masked)
    halo_lo_src_part: np.ndarray  # [P, H]
    halo_lo_src_idx: np.ndarray  # [P, H]
    halo_hi_src_part: np.ndarray  # [P, H]
    halo_hi_src_idx: np.ndarray  # [P, H]

    # packed point-to-point exchange (the reference's MPI ``exchange_nod``
    # analogue, docs/refactoring.md:200), generalized to MULTI-HOP: a part's
    # halo may be owned by parts up to ``neighbor_radius`` stripes away
    # (radius > 1 whenever block size < mesh bandwidth).  Hop ``r`` moves
    # one packed slab of width ``hop_up_w[r-1]`` (resp. dn) per direction
    # via ppermute(shift r); total comm = sum of true halo sizes (padded to
    # the per-hop max across parts), NOT P*B.
    neighbor_only: bool  # True iff neighbor_radius == 1
    neighbor_radius: int  # R: max |owner(halo) - part|
    # owned-block indices part p sends to p+r / p-r, packed in the order
    # the receiver's halo columns expect (ascending global id)
    hop_send_up: list  # R arrays [P, hop_up_w[r-1]] int32
    hop_send_dn: list  # R arrays [P, hop_dn_w[r-1]] int32
    # per halo column: owner hop distance (0 = padding column) and the
    # column's position inside that hop's packed slab
    halo_lo_hop: np.ndarray  # [P, H] int32
    halo_lo_pos: np.ndarray  # [P, H] int32
    halo_hi_hop: np.ndarray  # [P, H] int32
    halo_hi_pos: np.ndarray  # [P, H] int32
    halo_lo_mask: np.ndarray  # [P, H] valid lo-halo columns
    halo_hi_mask: np.ndarray  # [P, H] valid hi-halo columns

    @property
    def send_up_idx(self) -> np.ndarray:
        """[P, w] hop-1 up send list (the R == 1 fast-path view)."""
        return self.hop_send_up[0]

    @property
    def send_dn_idx(self) -> np.ndarray:
        return self.hop_send_dn[0]

    local_meshes: list  # list of per-part Mesh with local connectivity

    @property
    def n_local(self) -> int:
        return self.B + 2 * self.H

    @property
    def owned_off(self) -> int:
        """Column offset of the owned block (= H) in every part."""
        return self.H


def partition_mesh(mesh: Mesh, n_parts: int,
                   counts: "np.ndarray | None" = None) -> PartitionedMesh:
    """Partition into P contiguous owned ranges.

    ``counts`` (optional, [P]): per-part owned-node counts — pass the
    counts from :func:`mesh.ordering.rcb_order` after reordering the mesh
    with its permutation to realize a 2-D (recursive-bisection) partition
    through the same contiguous-range machinery (each RCB part is a
    contiguous range of the reordered numbering).  Default: equal split
    (1-D stripes of the bandwidth-ordered numbering)."""
    N = mesh.n_nodes
    if counts is None:
        bounds = np.linspace(0, N, n_parts + 1).astype(np.int64)
    else:
        assert len(counts) == n_parts and int(np.sum(counts)) == N
        bounds = np.zeros(n_parts + 1, dtype=np.int64)
        np.cumsum(counts, out=bounds[1:])
    owner = np.empty(N, dtype=np.int32)
    for p in range(n_parts):
        owner[bounds[p] : bounds[p + 1]] = p

    parts = []
    for p in range(n_parts):
        owned = np.arange(bounds[p], bounds[p + 1], dtype=np.int32)
        owned_set = np.zeros(N, dtype=bool)
        owned_set[owned] = True
        # local elements: any owned node
        e_mask = owned_set[mesh.elem_nodes].any(axis=1)
        elems = np.nonzero(e_mask)[0].astype(np.int32)
        # halo: nodes of local elements that are not owned, split by side
        enodes = np.unique(mesh.elem_nodes[elems])
        halo = enodes[~owned_set[enodes]].astype(np.int32)
        halo_lo = halo[halo < bounds[p]]
        halo_hi = halo[halo >= bounds[p + 1]]
        # local edges: any owned endpoint
        ed_mask = owned_set[mesh.edges].any(axis=1)
        eds = np.nonzero(ed_mask)[0].astype(np.int32)
        parts.append((owned, halo_lo, halo_hi, elems, eds))

    B = max(len(pt[0]) for pt in parts)
    H = max(max(len(pt[1]), len(pt[2])) for pt in parts)
    H = max(H, 1)
    E_loc = max(len(pt[3]) for pt in parts)
    Ed_loc = max(len(pt[4]) for pt in parts)

    P = n_parts
    n_loc = B + 2 * H
    local_nodes_global = np.full((P, n_loc), -1, dtype=np.int32)
    local_elems_global = np.full((P, E_loc), -1, dtype=np.int32)
    local_edges_global = np.full((P, Ed_loc), -1, dtype=np.int32)
    owned_count = np.zeros(P, dtype=np.int32)
    halo_lo_count = np.zeros(P, dtype=np.int32)
    halo_hi_count = np.zeros(P, dtype=np.int32)
    halo_lo_src_part = np.zeros((P, H), dtype=np.int32)
    halo_lo_src_idx = np.zeros((P, H), dtype=np.int32)
    halo_hi_src_part = np.zeros((P, H), dtype=np.int32)
    halo_hi_src_idx = np.zeros((P, H), dtype=np.int32)
    halo_lo_mask = np.zeros((P, H), dtype=bool)
    halo_hi_mask = np.zeros((P, H), dtype=bool)
    local_meshes = []

    for p, (owned, halo_lo, halo_hi, elems, eds) in enumerate(parts):
        no, h1, h2 = len(owned), len(halo_lo), len(halo_hi)
        owned_count[p] = no
        halo_lo_count[p] = h1
        halo_hi_count[p] = h2
        lo_pos = np.arange(H - h1, H)
        own_pos = np.arange(H, H + no)
        hi_pos = np.arange(H + B, H + B + h2)
        local_nodes_global[p, lo_pos] = halo_lo
        local_nodes_global[p, own_pos] = owned
        local_nodes_global[p, hi_pos] = halo_hi

        # per-side exchange source maps (pad positions -> own part, idx 0)
        halo_lo_src_part[p] = p
        halo_hi_src_part[p] = p
        if h1:
            halo_lo_src_part[p, H - h1:] = owner[halo_lo]
            halo_lo_src_idx[p, H - h1:] = halo_lo - bounds[owner[halo_lo]]
        if h2:
            halo_hi_src_part[p, :h2] = owner[halo_hi]
            halo_hi_src_idx[p, :h2] = halo_hi - bounds[owner[halo_hi]]

        halo_lo_mask[p, H - h1:] = True
        halo_hi_mask[p, :h2] = True

        local_elems_global[p, : len(elems)] = elems
        local_edges_global[p, : len(eds)] = eds

        # global -> local node map
        g2l = np.full(N, 0, dtype=np.int32)
        g2l[halo_lo] = lo_pos.astype(np.int32)
        g2l[owned] = own_pos.astype(np.int32)
        g2l[halo_hi] = hi_pos.astype(np.int32)

        g2l_edge = np.full(mesh.n_edges, -1, dtype=np.int32)
        g2l_edge[eds] = np.arange(len(eds), dtype=np.int32)
        g2l_elem = np.full(mesh.n_elems, -1, dtype=np.int32)
        g2l_elem[elems] = np.arange(len(elems), dtype=np.int32)

        local_meshes.append(
            _build_local_mesh(
                mesh, owned, halo_lo, halo_hi, elems, eds, g2l, g2l_elem,
                g2l_edge, B, H, E_loc, Ed_loc,
            )
        )

    # packed multi-hop send lists: part p's owned indices ordered as the
    # receiving part's halo columns expect them (ascending global id).
    # Hop r serves every (p -> p+-r) pair at once via ppermute(shift r);
    # per-hop slab widths are the max needed by any pair, so total comm is
    # proportional to the true halo sizes, not P*B.
    R = 1
    for p in range(P):
        _, halo_lo, halo_hi, _, _ = parts[p]
        if len(halo_lo):
            R = max(R, int(p - owner[halo_lo].min()))
        if len(halo_hi):
            R = max(R, int(owner[halo_hi].max() - p))
    halo_lo_hop = np.zeros((P, H), dtype=np.int32)
    halo_lo_pos = np.zeros((P, H), dtype=np.int32)
    halo_hi_hop = np.zeros((P, H), dtype=np.int32)
    halo_hi_pos = np.zeros((P, H), dtype=np.int32)
    up_lists = [[np.zeros(0, np.int32)] * P for _ in range(R)]
    dn_lists = [[np.zeros(0, np.int32)] * P for _ in range(R)]
    for p in range(P):
        _, halo_lo, halo_hi, _, _ = parts[p]
        h1, h2 = len(halo_lo), len(halo_hi)
        for r in range(1, R + 1):
            src = p - r
            if src >= 0 and h1:
                sel = owner[halo_lo] == src
                if sel.any():
                    gids = halo_lo[sel]  # ascending
                    up_lists[r - 1][src] = (gids - bounds[src]).astype(
                        np.int32)
                    cols = H - h1 + np.nonzero(sel)[0]
                    halo_lo_hop[p, cols] = r
                    halo_lo_pos[p, cols] = np.arange(len(gids))
            src = p + r
            if src < P and h2:
                sel = owner[halo_hi] == src
                if sel.any():
                    gids = halo_hi[sel]
                    dn_lists[r - 1][src] = (gids - bounds[src]).astype(
                        np.int32)
                    cols = np.nonzero(sel)[0]
                    halo_hi_hop[p, cols] = r
                    halo_hi_pos[p, cols] = np.arange(len(gids))

    def pack(lists):
        out = []
        for hop in lists:  # per-hop width: comm volume ~ true halo sizes
            w = max(max((len(a) for a in hop), default=0), 1)
            arr = np.zeros((P, w), dtype=np.int32)
            for p, a in enumerate(hop):
                arr[p, : len(a)] = a
            out.append(arr)
        return out

    hop_send_up = pack(up_lists)
    hop_send_dn = pack(dn_lists)

    return PartitionedMesh(
        mesh=mesh,
        n_parts=n_parts,
        B=B,
        H=H,
        E_loc=E_loc,
        Ed_loc=Ed_loc,
        owned_count=owned_count,
        halo_lo_count=halo_lo_count,
        halo_hi_count=halo_hi_count,
        local_nodes_global=local_nodes_global,
        local_elems_global=local_elems_global,
        local_edges_global=local_edges_global,
        halo_lo_src_part=halo_lo_src_part,
        halo_lo_src_idx=halo_lo_src_idx,
        halo_hi_src_part=halo_hi_src_part,
        halo_hi_src_idx=halo_hi_src_idx,
        neighbor_only=(R == 1),
        neighbor_radius=R,
        hop_send_up=hop_send_up,
        hop_send_dn=hop_send_dn,
        halo_lo_hop=halo_lo_hop,
        halo_lo_pos=halo_lo_pos,
        halo_hi_hop=halo_hi_hop,
        halo_hi_pos=halo_hi_pos,
        halo_lo_mask=halo_lo_mask,
        halo_hi_mask=halo_hi_mask,
        local_meshes=local_meshes,
    )


def _build_local_mesh(mesh, owned, halo_lo, halo_hi, elems, eds, g2l,
                      g2l_elem, g2l_edge, B, H, E_loc, Ed_loc) -> Mesh:
    """Re-index the global connectivity into the part's padded local space.

    Padded entities get nlev = 1 / nlev_edge = 0, which makes every activity
    mask false, and index 0, which is always a valid (inactive) slot."""
    no = len(owned)
    n_loc = B + 2 * H

    # node-level arrays via the local->global id list
    lids = np.full(n_loc, -1, dtype=np.int64)
    lids[H - len(halo_lo):H] = halo_lo
    lids[H:H + no] = owned
    lids[H + B:H + B + len(halo_hi)] = halo_hi
    present = lids >= 0
    safe = np.where(present, lids, 0)

    nlev_nod = np.where(present, mesh.nlev_nod[safe], 1).astype(np.int32)

    # elements (local node ids)
    elem_nodes = np.zeros((E_loc, 3), dtype=np.int32)
    elem_nodes[: len(elems)] = g2l[mesh.elem_nodes[elems]]
    nlev_elem = np.ones(E_loc, dtype=np.int32)
    nlev_elem[: len(elems)] = mesh.nlev_elem[elems]

    # edges (local node ids).  Local ids are ascending in global id, so the
    # canonical n0 < n1 orientation and the sort by min endpoint survive
    # re-indexing (the properties the Pallas split windows rely on).
    edges = np.zeros((Ed_loc, 2), dtype=np.int32)
    edges[: len(eds)] = g2l[mesh.edges[eds]]
    nlev_edge = np.zeros(Ed_loc, dtype=np.int32)
    nlev_edge[: len(eds)] = mesh.nlev_edge[eds]

    # node -> element incidence: complete for owned nodes only; halo and
    # padded rows carry count 0 (their cluster results are overwritten by
    # the halo exchange or never read)
    KE = mesh.node_elems.shape[1]
    node_elems = np.zeros((n_loc, KE), dtype=np.int32)
    node_elems_pos = np.zeros((n_loc, KE), dtype=np.int32)
    node_elems_num = np.zeros(n_loc, dtype=np.int32)
    ge = mesh.node_elems[owned]  # [no, KE] global elems (-1 pad)
    le = np.where(ge >= 0, g2l_elem[np.where(ge >= 0, ge, 0)], -1)
    assert (le[ge >= 0] >= 0).all(), "owned node touches non-local element"
    node_elems[H:H + no] = np.where(le >= 0, le, 0)
    node_elems_pos[H:H + no] = np.where(
        mesh.node_elems_pos[owned] >= 0, mesh.node_elems_pos[owned], 0
    )
    node_elems_num[H:H + no] = mesh.node_elems_num[owned]

    # node -> edge incidence: same owned-only contract
    KD = mesh.node_edges.shape[1]
    node_edges = np.zeros((n_loc, KD), dtype=np.int32)
    node_edges_sign = np.zeros((n_loc, KD), dtype=np.int8)
    node_edges_num = np.zeros(n_loc, dtype=np.int32)
    gd = mesh.node_edges[owned]
    ld = np.where(gd >= 0, g2l_edge[np.where(gd >= 0, gd, 0)], -1)
    assert (ld[gd >= 0] >= 0).all(), "owned node touches non-local edge"
    node_edges[H:H + no] = np.where(ld >= 0, ld, 0)
    node_edges_sign[H:H + no] = np.where(
        gd >= 0, mesh.node_edges_sign[owned], 0
    )
    node_edges_num[H:H + no] = mesh.node_edges_num[owned]

    # geometry
    node_xy = np.zeros((n_loc, 2))
    node_xy[present] = mesh.node_xy[lids[present]]
    area = np.ones((mesh.nl, n_loc))
    area[:, present] = mesh.area[:, lids[present]]

    return Mesh(
        nl=mesh.nl,
        elem_nodes=elem_nodes,
        edges=edges,
        edge_tri=np.full((Ed_loc, 2), -1, dtype=np.int32),  # unused downstream
        nlev_elem=nlev_elem,
        nlev_nod=nlev_nod,
        nlev_edge=nlev_edge,
        node_elems=node_elems,
        node_elems_pos=node_elems_pos,
        node_elems_num=node_elems_num,
        node_edges=node_edges,
        node_edges_sign=node_edges_sign,
        node_edges_num=node_edges_num,
        node_xy=node_xy,
        area=area,
        area_inv=1.0 / area,
    )


def scatter_node_field(pm: PartitionedMesh, field: np.ndarray) -> np.ndarray:
    """Global [*, N] node field -> per-part [P, *, 2H+B] (pad columns = 0)."""
    idx = np.where(pm.local_nodes_global >= 0, pm.local_nodes_global, 0)
    out = field[..., idx]  # [*, P, 2H+B]
    out = np.moveaxis(out, -2, 0)
    mask = pm.local_nodes_global >= 0
    out = out * mask.reshape((out.shape[0],) + (1,) * (out.ndim - 2) + (-1,))
    return np.ascontiguousarray(out)


def scatter_edge_field(pm: PartitionedMesh, field: np.ndarray) -> np.ndarray:
    """Global [*, Ed] edge field -> per-part [P, *, Ed_loc]."""
    idx = np.where(pm.local_edges_global >= 0, pm.local_edges_global, 0)
    out = field[..., idx]
    out = np.moveaxis(out, -2, 0)
    mask = pm.local_edges_global >= 0
    out = out * mask.reshape((out.shape[0],) + (1,) * (out.ndim - 2) + (-1,))
    return np.ascontiguousarray(out)


def gather_node_field(pm: PartitionedMesh, local: np.ndarray) -> np.ndarray:
    """Per-part [P, *, >=2H+B] -> global [*, N] using owned columns only."""
    N = pm.mesh.n_nodes
    H = pm.H
    lead = local.shape[1:-1]
    out = np.zeros(lead + (N,), dtype=local.dtype)
    for p in range(pm.n_parts):
        no = pm.owned_count[p]
        gids = pm.local_nodes_global[p, H:H + no]
        out[..., gids] = local[p, ..., H:H + no]
    return out


def gather_edge_field(pm: PartitionedMesh, local: np.ndarray) -> np.ndarray:
    """Per-part [P, *, >=Ed_loc] -> global [*, Ed].  Edges adjacent to a
    part boundary exist in several parts and carry equal values on a
    correct run (their endpoint data is exchanged); any writer wins."""
    Ed = pm.mesh.n_edges
    W = pm.local_edges_global.shape[1]
    lead = local.shape[1:-1]
    out = np.zeros(lead + (Ed,), dtype=local.dtype)
    for p in range(pm.n_parts):
        m = pm.local_edges_global[p] >= 0
        out[..., pm.local_edges_global[p][m]] = local[p, ..., :W][..., m]
    return out
