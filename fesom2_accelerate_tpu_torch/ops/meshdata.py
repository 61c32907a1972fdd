"""Device-resident mesh data for the PyTorch port.

Counterpart of ``fesom2_accelerate_tpu/ops/meshdata.py``: a frozen dataclass
of tensors (connectivity, activity masks, inverse areas) built once per mesh
on an explicit device.  The fields of the JAX ``MeshData`` keep their names
and meaning; more carry what the FCT CUDA kernels read per node
(``nlev_nod``, ``nd_num``, ``nd_lev``, ``nd_sgn``, with ``nd_other``
shared), per edge (``nlev_edge``, with ``edges`` shared), per node tile
(``ed_ptr``) and per element (``nlev_elem``, with ``elem_nodes`` shared),
and ``ne_slot`` is the node->element incidence that the stress2rhs kernel
reads, slot-major.

H-K34 writes every edge output from the block of the node tile in which
the edge starts.  The meshes the repo builds have their edges sorted by
their first endpoint and oriented n0 < n1 (``mesh/topology.py:
_build_edges``; a part keeps both, ``parallel/partition.py:
_build_local_mesh``), so the edges that start at node n are the index
range ``ed_ptr[n] .. ed_ptr[n+1]``, and those of a tile of nodes one range.
A part's padding edges, (0, 0) with no active level, are the tail after
``ed_ptr[N]``; the last tile passes them through.  On a part an edge from a
low-side halo column to an owned node is written by the tile of the halo
column.  ``ed_ptr`` is computed on first read, and reading it raises for
edges in any other order: only H-K34 needs it, so mesh data of any edge
order serves every other kernel and the plain stages, as the JAX package's
does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.mesh.topology import Mesh

# nodes in one tile of H-K1, H-K12 and H-K34 (kTileNodes in
# ops/cuda/csrc/fct_ale.cu), and the levels of one H-K12 block
# (kLimitFusedLevels there)
TILE_NODES = 32
LIMIT_FUSED_LEVELS = 24


@dataclasses.dataclass(frozen=True)
class MeshData:
    """Tensor mirror of Mesh connectivity + precomputed masks."""

    # connectivity (int32)
    elem_nodes: torch.Tensor  # [E, 3]
    edges: torch.Tensor  # [Ed, 2]
    ne_idx: torch.Tensor  # [N, KE] node->elem incidence (padded with 0)
    ne_pos: torch.Tensor  # [N, KE] local node position in the element
    nd_idx: torch.Tensor  # [N, KD] node->edge incidence (padded with 0)
    nd_other: torch.Tensor  # [N, KD] the OTHER endpoint of each incident edge

    # masks / weights
    node_mask: torch.Tensor  # [L, N] bool, z < nlev_nod - 1
    elem_mask: torch.Tensor  # [L, E] bool
    edge_mask: torch.Tensor  # [L, Ed] bool
    vint_mask: torch.Tensor  # [L+1, N] bool, active vertical interfaces
    ne_k: torch.Tensor  # [N, KE] bool, valid incidence slots
    nd_k: torch.Tensor  # [N, KD] bool
    nd_sign: torch.Tensor  # [N, KD] dtype, +-1 (-1 in padding, masked by nd_k)

    # geometry
    area_inv: torch.Tensor  # [L, N] (layer rows of 1/area)

    # vertical structure helpers
    surface_or_bottom: torch.Tensor  # [L, N] bool: z==0 or z>=nlev-2
    interior_row: torch.Tensor  # [L, N] bool: 1 <= z <= nlev-3
    not_surface: torch.Tensor  # [L, N] bool: z >= 1

    # per-node rows read by the CUDA kernels
    nlev_nod: torch.Tensor  # [N] int32
    nd_num: torch.Tensor  # [N] int32, valid slots of each nd_* row
    nd_lev: torch.Tensor  # [N, KD] int32, nlev_edge of the slot's edge (0 pad)
    nd_sgn: torch.Tensor  # [N, KD] int8, +1 first endpoint, -1 second (0 pad)
    nlev_edge: torch.Tensor  # [Ed] int32, active levels of each edge
    nlev_elem: torch.Tensor  # [E] int32, levels of each element (a2's mask)
    # [KE, N] int32, 3 * element + local position of each valid incidence
    # slot, -1 in padding; slot-major so that neighbouring node threads read
    # neighbouring words
    ne_slot: torch.Tensor

    @property
    def n_layers(self) -> int:
        return int(self.node_mask.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.node_mask.shape[1])

    @property
    def n_elems(self) -> int:
        return int(self.elem_nodes.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edge_mask.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.area_inv.dtype

    @property
    def device(self) -> torch.device:
        return self.area_inv.device

    @functools.cached_property
    def ed_ptr(self) -> torch.Tensor:
        """[N+1] int32 on the mesh data's device: the edges whose first
        endpoint is n are ``ed_ptr[n] .. ed_ptr[n+1]-1``, a part's padding
        edges follow ``ed_ptr[N]`` (see the module note).  Computed from
        ``edges`` on first read; raises as :func:`check_edge_order`."""
        head = self.edges[:check_edge_order(self.edges), 0].long()
        nodes = torch.arange(self.n_nodes + 1, device=head.device)
        return torch.searchsorted(head.contiguous(), nodes).to(torch.int32)

    @functools.cached_property
    def tile_edges(self) -> int:
        """The most edges that start in one tile of TILE_NODES nodes: the
        limited fluxes a level that H-K34 keeps in shared memory.  Read
        from ``ed_ptr`` on its device once per mesh data."""
        starts = torch.arange(0, self.n_nodes, TILE_NODES,
                              device=self.ed_ptr.device)
        ends = (starts + TILE_NODES).clamp(max=self.n_nodes)
        return int((self.ed_ptr[ends] - self.ed_ptr[starts]).max())


def check_edge_order(edges: torch.Tensor) -> int:
    """The number of edges that are not padding ((n, n)), after checking
    the order that ``MeshData.ed_ptr`` (H-K34's edge ranges) needs: those
    edges first, each oriented n0 < n1, sorted by n0.  Raises ValueError
    otherwise."""
    first, second = edges[:, 0].long(), edges[:, 1].long()
    n_real = int((first != second).sum())
    head = first[:n_real]
    if (bool((head >= second[:n_real]).any())
            or bool((first[n_real:] != second[n_real:]).any())
            or bool((head[1:] < head[:-1]).any())):
        raise ValueError("H-K34 needs the edges oriented n0 < n1, sorted by "
                         "n0, with the padding edges (n, n) last")
    return n_real


def _masks(mesh: Mesh) -> dict:
    """Activity masks and gather helper indices (the JAX package's
    ``ops/oracle.py:masks``)."""
    L = mesh.n_layers
    z = np.arange(L)[:, None]
    node_mask = z < (mesh.nlev_nod[None, :] - 1)  # [L, N]
    elem_mask = z < (mesh.nlev_elem[None, :] - 1)  # [L, E]
    edge_mask = z < mesh.nlev_edge[None, :]  # [L, Ed]
    zi = np.arange(L + 1)[:, None]
    vint_mask = zi < (mesh.nlev_nod[None, :] - 1)  # [L+1, N] active interfaces

    ne = mesh.node_elems
    ne_idx = np.where(ne >= 0, ne, 0)
    ne_k = np.arange(ne.shape[1])[None, :] < mesh.node_elems_num[:, None]

    nd = mesh.node_edges
    nd_idx = np.where(nd >= 0, nd, 0)
    nd_k = np.arange(nd.shape[1])[None, :] < mesh.node_edges_num[:, None]
    nd_sign = mesh.node_edges_sign.astype(np.float64)

    return dict(
        node_mask=node_mask,
        elem_mask=elem_mask,
        edge_mask=edge_mask,
        vint_mask=vint_mask,
        ne_idx=ne_idx,
        ne_k=ne_k,
        nd_idx=nd_idx,
        nd_k=nd_k,
        nd_sign=nd_sign,
    )


def _kernel_rows(nd_idx, nd_k, nd_sign, nlev_edge, nlev_nod, ne_idx, ne_pos,
                 ne_k) -> dict:
    """The per-node and per-edge rows the CUDA kernels read, from the
    shared fields."""
    return dict(
        nlev_nod=nlev_nod,
        nd_num=nd_k.sum(axis=1),
        nd_lev=np.where(nd_k, nlev_edge[nd_idx], 0),
        nd_sgn=np.where(nd_k, np.sign(nd_sign), 0),
        nlev_edge=nlev_edge,
        ne_slot=np.ascontiguousarray(
            np.where(ne_k, 3 * ne_idx.astype(np.int64) + ne_pos, -1).T),
    )


_INT32 = ("elem_nodes", "edges", "ne_idx", "ne_pos", "nd_idx", "nd_other",
          "nlev_nod", "nd_num", "nd_lev", "nlev_edge", "nlev_elem", "ne_slot")
_INT8 = ("nd_sgn",)
_FLOAT = ("nd_sign", "area_inv")


def _to_tensors(arrays: dict, dtype: torch.dtype,
                device: torch.device) -> MeshData:
    def conv(name, a):
        # torch.tensor copies, so the mesh data never aliases numpy memory
        if name in _INT32:
            return torch.tensor(np.asarray(a, dtype=np.int32), device=device)
        if name in _INT8:
            return torch.tensor(np.asarray(a, dtype=np.int8), device=device)
        if name in _FLOAT:
            return torch.tensor(np.asarray(a)).to(dtype=dtype, device=device)
        return torch.tensor(np.asarray(a, dtype=np.bool_), device=device)

    return MeshData(**{f.name: conv(f.name, arrays[f.name])
                       for f in dataclasses.fields(MeshData)})


def build_mesh_data(mesh: Mesh, dtype: torch.dtype,
                    device: torch.device | str) -> MeshData:
    """Build the mesh tensors on ``device``; float data in ``dtype``."""
    mk = _masks(mesh)
    L = mesh.n_layers
    z = np.arange(L)[:, None]
    bottom = mesh.nlev_nod[None, :] - 2
    surface_or_bottom = (z == 0) | (z >= bottom)
    interior_row = (z >= 1) & (z <= mesh.nlev_nod[None, :] - 3)
    not_surface = np.broadcast_to(z >= 1, (L, mesh.n_nodes))

    # other endpoint of each incident edge: sign +1 means this node is the
    # edge start, so the neighbour is the end node
    ends = mesh.edges[mk["nd_idx"]]  # [N, KD, 2]
    nd_other = np.where(mesh.node_edges_sign == 1, ends[:, :, 1],
                        ends[:, :, 0])
    nd_other = np.where(mesh.node_edges >= 0, nd_other, 0)

    ne_pos = np.where(mesh.node_elems_pos >= 0, mesh.node_elems_pos, 0)
    arrays = dict(
        elem_nodes=mesh.elem_nodes,
        edges=mesh.edges,
        ne_idx=mk["ne_idx"],
        ne_pos=ne_pos,
        nd_idx=mk["nd_idx"],
        nd_other=nd_other,
        node_mask=mk["node_mask"],
        elem_mask=mk["elem_mask"],
        edge_mask=mk["edge_mask"],
        vint_mask=mk["vint_mask"],
        ne_k=mk["ne_k"],
        nd_k=mk["nd_k"],
        nd_sign=mk["nd_sign"],
        area_inv=mesh.area_inv[:L],
        surface_or_bottom=surface_or_bottom,
        interior_row=interior_row,
        not_surface=not_surface,
        nlev_elem=mesh.nlev_elem,
        **_kernel_rows(mk["nd_idx"], mk["nd_k"], mk["nd_sign"],
                       mesh.nlev_edge, mesh.nlev_nod, mk["ne_idx"], ne_pos,
                       mk["ne_k"]),
    )
    return _to_tensors(arrays, dtype, torch.device(device))


def mesh_data_from_numpy(arrays: dict,
                         device: torch.device | str) -> MeshData:
    """The port's MeshData from the JAX package's ``MeshData`` arrays.

    ``arrays`` maps each field of the JAX ``MeshData`` to its value as a
    numpy array; the float dtype is that of ``area_inv``.  The rows only
    the CUDA kernels read are derived from those fields (``nlev_nod`` from
    the interface mask, ``nlev_edge`` from the edge mask, ``nlev_elem``
    from the element mask), so both packages are shown to compute on
    identical mesh data."""
    a = {k: np.asarray(v) for k, v in arrays.items()}
    nlev_edge = a["edge_mask"].sum(axis=0)
    nlev_nod = a["vint_mask"].sum(axis=0) + 1
    full = dict(a, nlev_elem=a["elem_mask"].sum(axis=0) + 1,
                **_kernel_rows(a["nd_idx"], a["nd_k"], a["nd_sign"],
                               nlev_edge, nlev_nod, a["ne_idx"], a["ne_pos"],
                               a["ne_k"]))
    dtype = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}[a["area_inv"].dtype]
    return _to_tensors(full, dtype, torch.device(device))
