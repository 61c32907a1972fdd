"""Plain PyTorch implementation of every FCT-ALE stage, and of the sea-ice
EVP ``stress2rhs``.

Counterpart of ``fesom2_accelerate_tpu/ops/stages.py``: the same masked
level-major math over a :class:`MeshData` of tensors.  In float64 it is the
correctness gate the tests hold against the JAX package and its numpy
oracle; on any device it is the plain version each CUDA kernel is checked
against (``ops/cuda/kernels.py``).  Every scatter of the reference is a
deterministic gather over the transposed incidence lists.
"""

from __future__ import annotations

import torch

from fesom2_accelerate_tpu_torch.ops.meshdata import MeshData

_BIG = 1e30


def _gather_nodes(field, idx):
    """field [L, X] gathered at idx [...] -> [L, *idx.shape]."""
    flat = torch.index_select(field, 1, idx.reshape(-1))
    return flat.reshape(field.shape[:1] + idx.shape)


def a1(md: MeshData, fct_LO, ttf):
    """Reference src/reference.cpp:306-319 (kernels/fct_ale_a1.cu)."""
    tmax = torch.where(md.node_mask, torch.maximum(fct_LO, ttf), 0.0)
    tmin = torch.where(md.node_mask, torch.minimum(fct_LO, ttf), 0.0)
    return tmax, tmin


def a2(md: MeshData, tmax, tmin, bignumber):
    """Reference src/reference.cpp:321-351 (kernels/fct_ale_a2.cu), with the
    CPU reference's full-depth padding semantics."""
    g_max = _gather_nodes(tmax, md.elem_nodes)  # [L, E, 3]
    g_min = _gather_nodes(tmin, md.elem_nodes)
    UV_max = torch.where(md.elem_mask, g_max.amax(dim=2), -bignumber)
    UV_min = torch.where(md.elem_mask, g_min.amin(dim=2), bignumber)
    return UV_max, UV_min


def _cluster_reduce(md: MeshData, UV_max, UV_min):
    """Max/min over the element cluster around each node -> [L, N].

    Reference kernels/fct_ale_a3.cu:9-24."""
    g_max = _gather_nodes(UV_max, md.ne_idx)  # [L, N, KE]
    g_min = _gather_nodes(UV_min, md.ne_idx)
    kmask = md.ne_k[None]
    tvert_max = torch.where(kmask, g_max, -_BIG).amax(dim=2)
    tvert_min = torch.where(kmask, g_min, _BIG).amin(dim=2)
    return tvert_max, tvert_min


def _vertical_window(arr, reduce_max: bool):
    """3-level running max/min along the level axis (z-1..z+1)."""
    pad = torch.full_like(arr[:1], -_BIG if reduce_max else _BIG)
    up = torch.cat([pad, arr[:-1]], dim=0)
    dn = torch.cat([arr[1:], pad], dim=0)
    if reduce_max:
        return torch.maximum(torch.maximum(up, arr), dn)
    return torch.minimum(torch.minimum(up, arr), dn)


def _a3_vlimit1_from_cluster(md: MeshData, tvert_max, tvert_min, fct_LO):
    """vlimit=1 epilogue: 3-level window over the cluster bounds, plain
    cluster bound on the surface and bottom rows, minus ``fct_LO``."""
    wmax = _vertical_window(tvert_max, reduce_max=True)
    wmin = _vertical_window(tvert_min, reduce_max=False)
    sel_max = torch.where(md.surface_or_bottom, tvert_max, wmax)
    sel_min = torch.where(md.surface_or_bottom, tvert_min, wmin)
    tmax = torch.where(md.node_mask, sel_max - fct_LO, 0.0)
    tmin = torch.where(md.node_mask, sel_min - fct_LO, 0.0)
    return tmax, tmin


def a3_vlimit1(md: MeshData, UV_max, UV_min, fct_LO):
    """Reference src/reference.cpp:353-392 / kernels/fct_ale_a3.cu:28-44."""
    tvert_max, tvert_min = _cluster_reduce(md, UV_max, UV_min)
    return _a3_vlimit1_from_cluster(md, tvert_max, tvert_min, fct_LO)


def _a3_vlimit23_from_cluster(md: MeshData, tvert_max, tvert_min,
                              fct_ttf_max_in, fct_LO, widen: bool):
    """vlimit=2/3 epilogue (docs/refactoring.md:113-148): both windows over
    a1's ``fct_ttf_max``, faithful to the Fortran lines 121/141."""
    wmax = _vertical_window(fct_ttf_max_in, reduce_max=True)
    wmin = _vertical_window(fct_ttf_max_in, reduce_max=False)
    if widen:
        cmax = torch.maximum(tvert_max, wmax)
        cmin = torch.minimum(tvert_min, wmin)
    else:
        cmax = torch.minimum(tvert_max, wmax)
        cmin = torch.maximum(tvert_min, wmin)
    sel_max = torch.where(md.interior_row, cmax, tvert_max)
    sel_min = torch.where(md.interior_row, cmin, tvert_min)
    tmax = torch.where(md.node_mask, sel_max - fct_LO, 0.0)
    tmin = torch.where(md.node_mask, sel_min - fct_LO, 0.0)
    return tmax, tmin


def _a3_vlimit23(md: MeshData, UV_max, UV_min, fct_ttf_max_in, fct_LO,
                 widen: bool):
    tvert_max, tvert_min = _cluster_reduce(md, UV_max, UV_min)
    return _a3_vlimit23_from_cluster(md, tvert_max, tvert_min,
                                     fct_ttf_max_in, fct_LO, widen)


def _cluster_reduce_via_edges(md: MeshData, tmax, tmin):
    """Element-cluster reduce WITHOUT materializing a2's UV arrays.

    The max over the elements around node n of the per-element 3-node max
    equals the max over n itself and its edge-neighbours m, where m takes
    part at level z iff z < nlev_edge(n, m): an edge's adjacent triangles
    are exactly the elements holding both endpoints.  Exact for
    |values| < bignumber, the reference's own padding assumption."""
    g_max = _gather_nodes(tmax, md.nd_other)  # [L, N, KD]
    g_min = _gather_nodes(tmin, md.nd_other)
    m = md.nd_k[None] & _gather_nodes(md.edge_mask, md.nd_idx)
    nbr_max = torch.where(m, g_max, -_BIG).amax(dim=2)
    nbr_min = torch.where(m, g_min, _BIG).amin(dim=2)
    self_max = torch.where(md.node_mask, tmax, -_BIG)
    self_min = torch.where(md.node_mask, tmin, _BIG)
    return torch.maximum(nbr_max, self_max), torch.minimum(nbr_min, self_min)


def a3_vlimit1_fused(md: MeshData, a1_tmax, a1_tmin, fct_LO):
    """vlimit=1 bounds from a1 output directly (a2 fused away)."""
    tvert_max, tvert_min = _cluster_reduce_via_edges(md, a1_tmax, a1_tmin)
    return _a3_vlimit1_from_cluster(md, tvert_max, tvert_min, fct_LO)


def a3(md: MeshData, UV_max, UV_min, a1_tmax, fct_LO, vlimit: int):
    if vlimit == 1:
        return a3_vlimit1(md, UV_max, UV_min, fct_LO)
    return _a3_vlimit23(md, UV_max, UV_min, a1_tmax, fct_LO,
                        widen=(vlimit == 2))


def b1_vertical(md: MeshData, fct_adf_v):
    """Reference kernels/fct_ale_b1_vertical.cu (overwrite semantics)."""
    up = fct_adf_v[:-1]
    dn = fct_adf_v[1:]
    plus = torch.clamp(up, min=0.0) + torch.clamp(-dn, min=0.0)
    minus = torch.clamp(up, max=0.0) + torch.clamp(-dn, max=0.0)
    plus = torch.where(md.node_mask, plus, 0.0)
    minus = torch.where(md.node_mask, minus, 0.0)
    return plus, minus


def b1_horizontal(md: MeshData, fct_plus, fct_minus, fct_adf_h):
    """Deterministic gather form of the atomicAdd scatter in reference
    kernels/fct_ale_b1_horizontal.cu:24-27."""
    x = md.nd_sign[None] * _gather_nodes(fct_adf_h, md.nd_idx)
    m = md.nd_k[None] & _gather_nodes(md.edge_mask, md.nd_idx)
    plus = fct_plus + torch.where(m, torch.clamp(x, min=0.0), 0.0).sum(dim=2)
    minus = fct_minus + torch.where(m, torch.clamp(x, max=0.0),
                                    0.0).sum(dim=2)
    return plus, minus


def b2(md: MeshData, fct_plus, fct_minus, tmax, tmin, dt, flux_eps):
    """Reference kernels/fct_ale_b2.cu:10-11 (area_inv form)."""
    fplus = fct_plus * dt * md.area_inv + flux_eps
    fminus = fct_minus * dt * md.area_inv - flux_eps
    plus = torch.clamp(tmax / fplus, max=1.0)
    minus = torch.clamp(tmin / fminus, max=1.0)
    plus = torch.where(md.node_mask, plus, 0.0)
    minus = torch.where(md.node_mask, minus, 0.0)
    return plus, minus


def b3_vertical(md: MeshData, fct_plus, fct_minus, fct_adf_v,
                iter_yn: bool):
    """Reference kernels/fct_ale_b3_vertical.cu / docs/refactoring.md:204-233.

    Shifted factor rows padded with 1.0 (limiter factors are <= 1) make the
    surface special case uniform.  A row is limited iff z < nlev_nod - 1;
    the bottom rows pass through unchanged."""
    ones = torch.ones_like(fct_plus[:1])
    plus_m1 = torch.cat([ones, fct_plus[:-1]], dim=0)
    minus_m1 = torch.cat([ones, fct_minus[:-1]], dim=0)
    flux = fct_adf_v[:-1]
    ae_pos = torch.clamp(torch.minimum(minus_m1, fct_plus), max=1.0)
    ae_neg = torch.clamp(torch.minimum(plus_m1, fct_minus), max=1.0)
    ae = torch.where(flux >= 0.0, ae_pos, ae_neg)
    active = md.vint_mask[:-1]
    out = torch.cat([torch.where(active, ae * flux, flux), fct_adf_v[-1:]],
                    dim=0)
    if iter_yn:
        resid = torch.where(active & md.not_surface, (1.0 - ae) * flux, 0.0)
        adf_v2 = torch.cat([resid, torch.zeros_like(fct_adf_v[-1:])], dim=0)
        return out, adf_v2
    return out, None


def b3_limit_edges(fct_plus, fct_minus, fct_adf_h, edges, edge_mask,
                   iter_yn: bool):
    """b3 horizontal on the edges given: ``edges`` [Ed', 2] endpoints,
    ``fct_adf_h`` and ``edge_mask`` [L, Ed'] their fluxes and activity."""
    n1 = edges[:, 0]
    n2 = edges[:, 1]
    p1 = torch.index_select(fct_plus, 1, n1)
    m1 = torch.index_select(fct_minus, 1, n1)
    p2 = torch.index_select(fct_plus, 1, n2)
    m2 = torch.index_select(fct_minus, 1, n2)
    ae_pos = torch.clamp(torch.minimum(p1, m2), max=1.0)
    ae_neg = torch.clamp(torch.minimum(m1, p2), max=1.0)
    ae = torch.where(fct_adf_h >= 0.0, ae_pos, ae_neg)
    out = torch.where(edge_mask, ae * fct_adf_h, fct_adf_h)
    if iter_yn:
        adf_h2 = torch.where(edge_mask, (1.0 - ae) * fct_adf_h, 0.0)
        return out, adf_h2
    return out, None


def b3_horizontal(md: MeshData, fct_plus, fct_minus, fct_adf_h,
                  iter_yn: bool):
    """Reference kernels/fct_ale_b3_horizontal.cu:28-39."""
    return b3_limit_edges(fct_plus, fct_minus, fct_adf_h, md.edges,
                          md.edge_mask, iter_yn)


def edge_flux_to_nodes(md: MeshData, fct_adf_h):
    """Signed masked sum of incident-edge fluxes per node -> [L, N].

    The gather form of the reference's c_horizontal atomic scatter
    (kernels/fct_ale_c_horizontal.cu:25-26)."""
    x = md.nd_sign[None] * _gather_nodes(fct_adf_h, md.nd_idx)
    m = md.nd_k[None] & _gather_nodes(md.edge_mask, md.nd_idx)
    return torch.where(m, x, 0.0).sum(dim=2)


def c_update_solution(md: MeshData, ttf, hnode, hnode_new, fct_LO,
                      fct_adf_v, fct_adf_h, del_ttf_advvert,
                      del_ttf_advhoriz, dt):
    """docs/refactoring.md:295-314 (kernels/fct_ale_c_{vertical,horizontal})."""
    dv = (
        -ttf * hnode
        + fct_LO * hnode_new
        + (fct_adf_v[:-1] - fct_adf_v[1:]) * dt * md.area_inv
    )
    del_v = torch.where(md.node_mask, del_ttf_advvert + dv, del_ttf_advvert)
    dh = edge_flux_to_nodes(md, fct_adf_h) * dt * md.area_inv
    del_h = del_ttf_advhoriz + dh
    return del_v, del_h


def c_update_LO(md: MeshData, fct_LO, fct_adf_v, fct_adf_h, hnode_new, dt):
    """docs/refactoring.md:269-286 (iterative FCT)."""
    dv = (fct_adf_v[:-1] - fct_adf_v[1:]) * dt * md.area_inv / hnode_new
    out = torch.where(md.node_mask, fct_LO + dv, fct_LO)
    dh = edge_flux_to_nodes(md, fct_adf_h) * dt * md.area_inv / hnode_new
    return out + dh


def stress2rhs(md: MeshData, elem_area, ice_strength, sigma11, sigma12,
               sigma22, gradient_sca, metric_factor, inv_areamass,
               rhs_a, rhs_m):
    """Sea-ice EVP stress divergence, gather form.

    Reference src/reference.cpp:440-480; the element->node scatter becomes a
    masked sum over each node's incident elements with its local gradient
    coefficient."""
    idx = md.ne_idx.long()  # [N, KE]
    pos = md.ne_pos.long()
    E = elem_area.shape[0]

    active = md.ne_k & (torch.take(ice_strength, idx) > 0.0)

    gflat = gradient_sca.reshape(-1)  # [6 * E]
    g_k = torch.take(gflat, pos * E + idx)
    g_k3 = torch.take(gflat, (pos + 3) * E + idx)
    ea = torch.take(elem_area, idx)
    s11 = torch.take(sigma11, idx)
    s12 = torch.take(sigma12, idx)
    s22 = torch.take(sigma22, idx)
    mf3 = torch.take(metric_factor, idx) * (1.0 / 3.0)

    u_c = -ea * (s11 * g_k + s12 * g_k3 + s12 * mf3)
    v_c = -ea * (s12 * g_k + s22 * g_k3 - s11 * mf3)
    U = torch.where(active, u_c, 0.0).sum(dim=1)
    V = torch.where(active, v_c, 0.0).sum(dim=1)

    has_mass = inv_areamass > 0.0
    U = torch.where(has_mass, U * inv_areamass + rhs_a, 0.0)
    V = torch.where(has_mass, V * inv_areamass + rhs_m, 0.0)
    return U, V
