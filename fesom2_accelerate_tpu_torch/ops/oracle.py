"""Vectorized numpy oracle for FCT-ALE (f64), the port's copy.

A copy of ``fesom2_accelerate_tpu/ops/oracle.py`` with every function and
name kept (``masks``, ``a1``, ``a2``, ``a3_vlimit1/2/3``, ``b1_*``, ``b2``,
``b3_*``, ``c_*``, ``fct_ale_step``, ``stress2rhs``): the port cannot import
the JAX package, whose ``__init__`` imports jax, and runs where there is
no jax.  The code is kept identical, so both give the same bits on the same
mesh; ``tests/test_torch_oracle.py`` holds the port to that.  It takes the
port's :class:`~fesom2_accelerate_tpu_torch.mesh.topology.Mesh`.

Same semantics as :mod:`oracle_loops` (the literal transcription of reference
src/reference.cpp:306-438 + docs/refactoring.md:12-316), written as masked
dense array ops over the level-major ``[L, X]`` layout.  It is validated
against the loop oracle on tiny meshes (tests/test_oracle.py) and then
serves as the fast correctness anchor for the XLA / Pallas / sharded paths on
large meshes — the same two-tier oracle strategy the reference uses (numpy
``reference()`` vs CPU ``reference.cpp``, kernels/fct_ale_a1.py:50-55).

Masking convention: all outputs are exactly 0 outside the active region
(level >= active layer count of the entity); the loop oracle also zero-fills
there, so comparisons can be whole-array exact.
"""

from __future__ import annotations

import numpy as np

from fesom2_accelerate_tpu_torch.mesh.topology import Mesh

_BIG = 1e30


def masks(mesh: Mesh) -> dict:
    """Precomputed activity masks and gather helper indices for a mesh."""
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


def a1(mesh: Mesh, mk: dict, fct_LO, ttf):
    """Reference src/reference.cpp:306-319."""
    tmax = np.where(mk["node_mask"], np.maximum(fct_LO, ttf), 0.0)
    tmin = np.where(mk["node_mask"], np.minimum(fct_LO, ttf), 0.0)
    return tmax, tmin


def a2(mesh: Mesh, mk: dict, tmax, tmin, bignumber=1e3):
    """Reference src/reference.cpp:321-351 (full-depth bignumber padding)."""
    en = mesh.elem_nodes  # [E, 3]
    g_max = tmax[:, en]  # [L, E, 3]
    g_min = tmin[:, en]
    UV_max = np.where(mk["elem_mask"], g_max.max(axis=2), -bignumber)
    UV_min = np.where(mk["elem_mask"], g_min.min(axis=2), bignumber)
    return UV_max, UV_min


def _cluster_reduce(mesh: Mesh, mk: dict, UV_max, UV_min):
    """Max/min of UV over the elements around each node -> [L, N].

    Inactive element levels carry -/+bignumber from a2 so they never win;
    padded incidence slots are masked with -/+_BIG."""
    g_max = UV_max[:, mk["ne_idx"]]  # [L, N, KE]
    g_min = UV_min[:, mk["ne_idx"]]
    kmask = mk["ne_k"][None, :, :]
    tvert_max = np.where(kmask, g_max, -_BIG).max(axis=2)
    tvert_min = np.where(kmask, g_min, _BIG).min(axis=2)
    return tvert_max, tvert_min


def _vertical_window(arr, reduce_max: bool):
    """3-level running max/min along axis 0 (out[z] over z-1..z+1)."""
    L = arr.shape[0]
    pad = np.full((1,) + arr.shape[1:], -_BIG if reduce_max else _BIG,
                  dtype=arr.dtype)
    up = np.concatenate([pad, arr[:-1]], axis=0)  # arr[z-1]
    dn = np.concatenate([arr[1:], pad], axis=0)  # arr[z+1]
    if reduce_max:
        return np.maximum(np.maximum(up, arr), dn)
    return np.minimum(np.minimum(up, arr), dn)


def a3_vlimit1(mesh: Mesh, mk: dict, UV_max, UV_min, fct_LO):
    """Reference src/reference.cpp:353-392: cluster bounds + 3-level window
    with surface (z=0) and bottom (z=nlev-2) rows using the unwidened
    cluster bound."""
    tvert_max, tvert_min = _cluster_reduce(mesh, mk, UV_max, UV_min)
    wmax = _vertical_window(tvert_max, reduce_max=True)
    wmin = _vertical_window(tvert_min, reduce_max=False)
    L = mesh.n_layers
    z = np.arange(L)[:, None]
    bottom = mesh.nlev_nod[None, :] - 2
    use_plain = (z == 0) | (z >= bottom)
    sel_max = np.where(use_plain, tvert_max, wmax)
    sel_min = np.where(use_plain, tvert_min, wmin)
    tmax = np.where(mk["node_mask"], sel_max - fct_LO, 0.0)
    tmin = np.where(mk["node_mask"], sel_min - fct_LO, 0.0)
    return tmax, tmin


def _a3_vlimit23(mesh: Mesh, mk: dict, UV_max, UV_min, fct_ttf_max_in,
                 fct_LO, widen: bool):
    """Shared vlimit=2/3 body (docs/refactoring.md:113-148).

    widen=True (vlimit 2): tmax = max(cluster, window); tmin = min(...).
    widen=False (vlimit 3): tmax = min(cluster, window); tmin = max(...).
    Both windows come from fct_ttf_max_in, faithful to the Fortran
    (docs/refactoring.md:121,141).  The window only applies to interior rows
    1 <= z <= nlev-3."""
    tvert_max, tvert_min = _cluster_reduce(mesh, mk, UV_max, UV_min)
    wmax = _vertical_window(fct_ttf_max_in, reduce_max=True)
    wmin = _vertical_window(fct_ttf_max_in, reduce_max=False)
    L = mesh.n_layers
    z = np.arange(L)[:, None]
    interior = (z >= 1) & (z <= mesh.nlev_nod[None, :] - 3)
    if widen:
        cmax = np.maximum(tvert_max, wmax)
        cmin = np.minimum(tvert_min, wmin)
    else:
        cmax = np.minimum(tvert_max, wmax)
        cmin = np.maximum(tvert_min, wmin)
    sel_max = np.where(interior, cmax, tvert_max)
    sel_min = np.where(interior, cmin, tvert_min)
    tmax = np.where(mk["node_mask"], sel_max - fct_LO, 0.0)
    tmin = np.where(mk["node_mask"], sel_min - fct_LO, 0.0)
    return tmax, tmin


def a3_vlimit2(mesh, mk, UV_max, UV_min, fct_ttf_max_in, fct_LO):
    return _a3_vlimit23(mesh, mk, UV_max, UV_min, fct_ttf_max_in, fct_LO,
                        widen=True)


def a3_vlimit3(mesh, mk, UV_max, UV_min, fct_ttf_max_in, fct_LO):
    return _a3_vlimit23(mesh, mk, UV_max, UV_min, fct_ttf_max_in, fct_LO,
                        widen=False)


def b1_vertical(mesh: Mesh, mk: dict, fct_adf_v):
    """Reference src/reference.cpp:393-399."""
    up = fct_adf_v[:-1]  # interface above layer z
    dn = fct_adf_v[1:]  # interface below layer z
    plus = np.maximum(0.0, up) + np.maximum(0.0, -dn)
    minus = np.minimum(0.0, up) + np.minimum(0.0, -dn)
    plus = np.where(mk["node_mask"], plus, 0.0)
    minus = np.where(mk["node_mask"], minus, 0.0)
    return plus, minus


def b1_horizontal(mesh: Mesh, mk: dict, fct_plus, fct_minus, fct_adf_h):
    """Scatter-as-gather over the transposed edge incidence.

    Reference semantics src/reference.cpp:406-425; the atomic-add scatter
    (kernels/fct_ale_b1_horizontal.cu:24-27) becomes a deterministic masked
    sum over each node's incident edges."""
    x = mk["nd_sign"][None, :, :] * fct_adf_h[:, mk["nd_idx"]]  # [L, N, KD]
    m = mk["nd_k"][None, :, :] & mk["edge_mask"][:, mk["nd_idx"]]
    plus = fct_plus + np.sum(np.where(m, np.maximum(0.0, x), 0.0), axis=2)
    minus = fct_minus + np.sum(np.where(m, np.minimum(0.0, x), 0.0), axis=2)
    return plus, minus


def b2(mesh: Mesh, mk: dict, fct_plus, fct_minus, tmax, tmin, dt,
       flux_eps=1e-16):
    """Reference src/reference.cpp:426-437."""
    ai = mesh.area_inv[: mesh.n_layers]
    fplus = fct_plus * dt * ai + flux_eps
    fminus = fct_minus * dt * ai - flux_eps
    plus = np.minimum(1.0, tmax / fplus)
    minus = np.minimum(1.0, tmin / fminus)
    plus = np.where(mk["node_mask"], plus, 0.0)
    minus = np.where(mk["node_mask"], minus, 0.0)
    return plus, minus


def b3_vertical(mesh: Mesh, mk: dict, fct_plus, fct_minus, fct_adf_v,
                iter_yn=False):
    """docs/refactoring.md:204-233.  For z=0 only the level-0 factor is
    used; padding the shifted factor rows with 1.0 makes the z>=1 formula
    uniform because limiter factors never exceed 1."""
    L = mesh.n_layers
    ones = np.ones((1, fct_plus.shape[1]), dtype=fct_plus.dtype)
    plus_m1 = np.concatenate([ones, fct_plus[:-1]], axis=0)  # fct_plus[z-1]
    minus_m1 = np.concatenate([ones, fct_minus[:-1]], axis=0)
    flux = fct_adf_v[:-1]  # rows 0..L-1 are the limitable interfaces
    ae_pos = np.minimum(1.0, np.minimum(minus_m1, fct_plus))
    ae_neg = np.minimum(1.0, np.minimum(plus_m1, fct_minus))
    ae = np.where(flux >= 0.0, ae_pos, ae_neg)
    active = mk["vint_mask"][:-1]
    out = fct_adf_v.copy()
    out[:-1] = np.where(active, ae * flux, flux)
    if iter_yn:
        z = np.arange(L)[:, None]
        adf_v2 = np.zeros_like(fct_adf_v)
        adf_v2[:-1] = np.where(active & (z >= 1), (1.0 - ae) * flux, 0.0)
        return out, adf_v2
    return out


def b3_horizontal(mesh: Mesh, mk: dict, fct_plus, fct_minus, fct_adf_h,
                  iter_yn=False):
    """docs/refactoring.md:238-263."""
    n1 = mesh.edges[:, 0]
    n2 = mesh.edges[:, 1]
    p1, m1 = fct_plus[:, n1], fct_minus[:, n1]
    p2, m2 = fct_plus[:, n2], fct_minus[:, n2]
    ae_pos = np.minimum(1.0, np.minimum(p1, m2))
    ae_neg = np.minimum(1.0, np.minimum(m1, p2))
    ae = np.where(fct_adf_h >= 0.0, ae_pos, ae_neg)
    out = np.where(mk["edge_mask"], ae * fct_adf_h, fct_adf_h)
    if iter_yn:
        adf_h2 = np.where(mk["edge_mask"], (1.0 - ae) * fct_adf_h, 0.0)
        return out, adf_h2
    return out


def _edge_flux_to_nodes(mesh: Mesh, mk: dict, fct_adf_h):
    """Signed masked sum of incident-edge fluxes per node: [L, N]."""
    x = mk["nd_sign"][None, :, :] * fct_adf_h[:, mk["nd_idx"]]
    m = mk["nd_k"][None, :, :] & mk["edge_mask"][:, mk["nd_idx"]]
    return np.sum(np.where(m, x, 0.0), axis=2)


def c_update_solution(mesh: Mesh, mk: dict, ttf, hnode, hnode_new, fct_LO,
                      fct_adf_v, fct_adf_h, del_ttf_advvert,
                      del_ttf_advhoriz, dt):
    """docs/refactoring.md:295-314 (non-iterative)."""
    ai = mesh.area_inv[: mesh.n_layers]
    dv = (
        -ttf * hnode
        + fct_LO * hnode_new
        + (fct_adf_v[:-1] - fct_adf_v[1:]) * dt * ai
    )
    del_v = np.where(mk["node_mask"], del_ttf_advvert + dv, del_ttf_advvert)
    dh = _edge_flux_to_nodes(mesh, mk, fct_adf_h) * dt * ai
    del_h = del_ttf_advhoriz + dh
    return del_v, del_h


def c_update_LO(mesh: Mesh, mk: dict, fct_LO, fct_adf_v, fct_adf_h,
                hnode_new, dt):
    """docs/refactoring.md:269-286 (iterative)."""
    ai = mesh.area_inv[: mesh.n_layers]
    dv = (fct_adf_v[:-1] - fct_adf_v[1:]) * dt * ai / hnode_new
    out = np.where(mk["node_mask"], fct_LO + dv, fct_LO)
    dh = _edge_flux_to_nodes(mesh, mk, fct_adf_h) * dt * ai / hnode_new
    return out + dh


def fct_ale_step(mesh: Mesh, fields: dict, vlimit=1, iter_yn=False,
                 dt=1.0, flux_eps=1e-16, bignumber=1e3, mk=None) -> dict:
    """Full chain; same contract as oracle_loops.fct_ale_step."""
    if mk is None:
        mk = masks(mesh)
    ttf = fields["ttf"]
    fct_LO = fields["fct_LO"]
    tmax, tmin = a1(mesh, mk, fct_LO, ttf)
    UV_max, UV_min = a2(mesh, mk, tmax, tmin, bignumber)
    if vlimit == 1:
        tmax2, tmin2 = a3_vlimit1(mesh, mk, UV_max, UV_min, fct_LO)
    elif vlimit == 2:
        tmax2, tmin2 = a3_vlimit2(mesh, mk, UV_max, UV_min, tmax, fct_LO)
    else:
        tmax2, tmin2 = a3_vlimit3(mesh, mk, UV_max, UV_min, tmax, fct_LO)
    fct_plus, fct_minus = b1_vertical(mesh, mk, fields["fct_adf_v"])
    fct_plus, fct_minus = b1_horizontal(
        mesh, mk, fct_plus, fct_minus, fields["fct_adf_h"]
    )
    fct_plus, fct_minus = b2(
        mesh, mk, fct_plus, fct_minus, tmax2, tmin2, dt, flux_eps
    )
    if iter_yn:
        adf_v, adf_v2 = b3_vertical(
            mesh, mk, fct_plus, fct_minus, fields["fct_adf_v"], iter_yn=True
        )
        adf_h, adf_h2 = b3_horizontal(
            mesh, mk, fct_plus, fct_minus, fields["fct_adf_h"], iter_yn=True
        )
        new_LO = c_update_LO(
            mesh, mk, fct_LO, adf_v, adf_h, fields["hnode_new"], dt
        )
        return dict(
            fct_ttf_max=tmax2, fct_ttf_min=tmin2,
            fct_plus=fct_plus, fct_minus=fct_minus,
            fct_adf_v=adf_v2, fct_adf_h=adf_h2,
            fct_adf_v_limited=adf_v, fct_adf_h_limited=adf_h,
            fct_LO=new_LO,
        )
    adf_v = b3_vertical(mesh, mk, fct_plus, fct_minus, fields["fct_adf_v"])
    adf_h = b3_horizontal(mesh, mk, fct_plus, fct_minus, fields["fct_adf_h"])
    del_v, del_h = c_update_solution(
        mesh, mk, ttf, fields["hnode"], fields["hnode_new"], fct_LO,
        adf_v, adf_h,
        fields["del_ttf_advvert"], fields["del_ttf_advhoriz"], dt,
    )
    return dict(
        fct_ttf_max=tmax2, fct_ttf_min=tmin2,
        fct_plus=fct_plus, fct_minus=fct_minus,
        fct_adf_v=adf_v, fct_adf_h=adf_h,
        del_ttf_advvert=del_v, del_ttf_advhoriz=del_h,
    )


def stress2rhs(elem_nodes, node_elems, node_elems_pos, node_elems_num,
               elem_area, ice_strength, sigma11, sigma12, sigma22,
               gradient_sca, metric_factor, inv_areamass, rhs_a, rhs_m):
    """Vectorized stress2rhs via the transposed node->element incidence.

    Reference: src/reference.cpp:440-480.  The element->node scatter becomes
    a gather: each node sums the contribution of each incident element,
    picking the gradient coefficient for its local position in the element."""
    KE = node_elems.shape[1]
    idx = np.where(node_elems >= 0, node_elems, 0)  # [N, KE]
    pos = np.where(node_elems_pos >= 0, node_elems_pos, 0)
    kmask = np.arange(KE)[None, :] < node_elems_num[:, None]
    active = kmask & (ice_strength[idx] > 0.0)

    g_k = gradient_sca[pos, idx]  # gradient_sca[k, e]
    g_k3 = gradient_sca[pos + 3, idx]
    ea = elem_area[idx]
    s11, s12, s22 = sigma11[idx], sigma12[idx], sigma22[idx]
    mf3 = metric_factor[idx] * (1.0 / 3.0)

    u_c = -ea * (s11 * g_k + s12 * g_k3 + s12 * mf3)
    v_c = -ea * (s12 * g_k + s22 * g_k3 - s11 * mf3)
    U = np.sum(np.where(active, u_c, 0.0), axis=1)
    V = np.sum(np.where(active, v_c, 0.0), axis=1)

    has_mass = inv_areamass > 0.0
    U = np.where(has_mass, U * inv_areamass + rhs_a, 0.0)
    V = np.where(has_mass, V * inv_areamass + rhs_m, 0.0)
    return U, V
