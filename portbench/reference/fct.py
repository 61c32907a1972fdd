"""The plain reference of one FCT-ALE step (Zalesak limiter on ALE layers).

Masked dense tensor operations over the level-major ``[L, X]`` layout,
after FESOM2's ``oce_adv_tra_fct.F90`` as the reference library states it
(a1 bounds, a2 element extrema, a3 cluster bounds with the vlimit 1
vertical window, b1 fluxes into nodes, b2 limiter factors, b3 limited
fluxes, c increments); every scatter is a gather over the node incidence
lists of :mod:`portbench.reference.mesh`.  It imports nothing of the
program: it takes the raw fields and its own mesh, and runs in any float
dtype on any device (float64 for the check, bfloat16 for the control).
"""

from __future__ import annotations

import torch

from portbench.reference.mesh import RefMesh

_BIG = 1e30


class Masks:
    """A mesh's activity masks and gather indices as tensors on a device;
    ``area_inv`` in ``dtype``."""

    def __init__(self, mesh: RefMesh, dtype: torch.dtype, device):
        def t(a, dt=None):
            return torch.as_tensor(a, device=device, dtype=dt)

        L = mesh.n_layers
        z = torch.arange(L, device=device)[:, None]
        nlev_nod = t(mesh.nlev_nod, torch.int64)
        self.node_mask = z < nlev_nod[None] - 1
        self.elem_mask = z < t(mesh.nlev_elem, torch.int64)[None] - 1
        self.edge_mask = z < t(mesh.nlev_edge, torch.int64)[None]
        zi = torch.arange(L + 1, device=device)[:, None]
        self.vint_mask = zi < nlev_nod[None] - 1
        self.plain_row = (z == 0) | (z >= nlev_nod[None] - 2)
        self.not_surface = z >= 1
        ne = t(mesh.node_elems, torch.int64)
        self.ne_idx = ne.clamp(min=0)
        self.ne_k = (torch.arange(ne.shape[1], device=device)[None]
                     < t(mesh.node_elems_num, torch.int64)[:, None])
        nd = t(mesh.node_edges, torch.int64)
        self.nd_idx = nd.clamp(min=0)
        self.nd_k = (torch.arange(nd.shape[1], device=device)[None]
                     < t(mesh.node_edges_num, torch.int64)[:, None])
        self.nd_sign = t(mesh.node_edges_sign, dtype)
        self.elem_nodes = t(mesh.elem_nodes, torch.int64)
        self.edges = t(mesh.edges, torch.int64)
        self.area_inv = (1.0 / t(mesh.area[:L], torch.float64)).to(dtype)


def _window(a, reduce_max: bool):
    """out[z] = max (min) of a[z-1], a[z], a[z+1]."""
    pad = torch.full_like(a[:1], -_BIG if reduce_max else _BIG)
    up = torch.cat([pad, a[:-1]])
    dn = torch.cat([a[1:], pad])
    op = torch.maximum if reduce_max else torch.minimum
    return op(op(up, a), dn)


def _edge_sum(mk: Masks, fct_adf_h, part=None):
    """Each node's signed incident-edge fluxes [L, N, KD] where the edge
    is active (``part`` keeps their positive or negative parts), summed."""
    x = mk.nd_sign[None] * fct_adf_h[:, mk.nd_idx]
    live = mk.nd_k[None] & mk.edge_mask[:, mk.nd_idx]
    if part == "plus":
        x = x.clamp(min=0.0)
    elif part == "minus":
        x = x.clamp(max=0.0)
    return torch.where(live, x, 0.0).sum(dim=2)


def bounds(mk: Masks, ttf, fct_LO, bignumber: float = 1e3):
    """a1 -> a2 -> a3 (vlimit 1): each node-layer's admissible increase and
    decrease (``fct_ttf_max``, ``fct_ttf_min``)."""
    tmax = torch.where(mk.node_mask, torch.maximum(fct_LO, ttf), 0.0)
    tmin = torch.where(mk.node_mask, torch.minimum(fct_LO, ttf), 0.0)
    en = mk.elem_nodes
    uv_max = torch.where(mk.elem_mask, tmax[:, en].amax(dim=2), -bignumber)
    uv_min = torch.where(mk.elem_mask, tmin[:, en].amin(dim=2), bignumber)
    k = mk.ne_k[None]
    cmax = torch.where(k, uv_max[:, mk.ne_idx], -_BIG).amax(dim=2)
    cmin = torch.where(k, uv_min[:, mk.ne_idx], _BIG).amin(dim=2)
    sel_max = torch.where(mk.plain_row, cmax, _window(cmax, True))
    sel_min = torch.where(mk.plain_row, cmin, _window(cmin, False))
    return (torch.where(mk.node_mask, sel_max - fct_LO, 0.0),
            torch.where(mk.node_mask, sel_min - fct_LO, 0.0))


def factors(mk: Masks, tmax, tmin, fct_adf_v, fct_adf_h, dt, flux_eps):
    """b1 -> b2: the limiter factors ``fct_plus``, ``fct_minus``."""
    up, dn = fct_adf_v[:-1], fct_adf_v[1:]
    plus = up.clamp(min=0.0) + (-dn).clamp(min=0.0)
    minus = up.clamp(max=0.0) + (-dn).clamp(max=0.0)
    plus = torch.where(mk.node_mask, plus, 0.0) + _edge_sum(
        mk, fct_adf_h, "plus")
    minus = torch.where(mk.node_mask, minus, 0.0) + _edge_sum(
        mk, fct_adf_h, "minus")
    plus = (tmax / (plus * dt * mk.area_inv + flux_eps)).clamp(max=1.0)
    minus = (tmin / (minus * dt * mk.area_inv - flux_eps)).clamp(max=1.0)
    return (torch.where(mk.node_mask, plus, 0.0),
            torch.where(mk.node_mask, minus, 0.0))


def limit(mk: Masks, plus, minus, fct_adf_v, fct_adf_h):
    """b3: (limited vertical, limited horizontal, and each one's
    unlimited remainder) fluxes."""
    ones = torch.ones_like(plus[:1])
    flux = fct_adf_v[:-1]
    ae_v = torch.where(
        flux >= 0.0,
        torch.minimum(torch.cat([ones, minus[:-1]]), plus).clamp(max=1.0),
        torch.minimum(torch.cat([ones, plus[:-1]]), minus).clamp(max=1.0))
    act = mk.vint_mask[:-1]
    adf_v = torch.cat([torch.where(act, ae_v * flux, flux), fct_adf_v[-1:]])
    res_v = torch.cat([torch.where(act & mk.not_surface,
                                   (1.0 - ae_v) * flux, 0.0),
                       torch.zeros_like(fct_adf_v[-1:])])
    n1, n2 = mk.edges[:, 0], mk.edges[:, 1]
    ae_h = torch.where(
        fct_adf_h >= 0.0,
        torch.minimum(plus[:, n1], minus[:, n2]).clamp(max=1.0),
        torch.minimum(minus[:, n1], plus[:, n2]).clamp(max=1.0))
    adf_h = torch.where(mk.edge_mask, ae_h * fct_adf_h, fct_adf_h)
    res_h = torch.where(mk.edge_mask, (1.0 - ae_h) * fct_adf_h, 0.0)
    return adf_v, adf_h, res_v, res_h


def step(mk: Masks, f: dict, *, dt: float, flux_eps: float,
         iter_yn: bool = False) -> dict:
    """One step of one tracer: the fields a host reads back.  ``f`` holds
    ``ttf``, ``fct_LO``, ``hnode``, ``hnode_new``, ``del_ttf_advvert``,
    ``del_ttf_advhoriz`` [L, N], ``fct_adf_v`` [L+1, N] and ``fct_adf_h``
    [L, Ed] in one dtype.  Non-iterative: the limited fluxes and the
    increments with the limited fluxes' divergence added; iterative:
    the new ``fct_LO`` and the remainders as the next fluxes."""
    tmax, tmin = bounds(mk, f["ttf"], f["fct_LO"])
    plus, minus = factors(mk, tmax, tmin, f["fct_adf_v"], f["fct_adf_h"],
                          dt, flux_eps)
    adf_v, adf_h, res_v, res_h = limit(mk, plus, minus, f["fct_adf_v"],
                                       f["fct_adf_h"])
    ai = mk.area_inv
    div_v = (adf_v[:-1] - adf_v[1:]) * dt * ai
    div_h = _edge_sum(mk, adf_h) * dt * ai
    if iter_yn:
        lo = f["fct_LO"]
        lo = torch.where(mk.node_mask, lo + div_v / f["hnode_new"], lo)
        return dict(fct_LO=lo + div_h / f["hnode_new"], fct_adf_v=res_v,
                    fct_adf_h=res_h)
    dv = -f["ttf"] * f["hnode"] + f["fct_LO"] * f["hnode_new"] + div_v
    d_v = f["del_ttf_advvert"]
    return dict(fct_adf_v=adf_v, fct_adf_h=adf_h,
                del_ttf_advvert=torch.where(mk.node_mask, d_v + dv, d_v),
                del_ttf_advhoriz=f["del_ttf_advhoriz"] + div_h)
