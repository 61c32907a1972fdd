"""Literal loop transcription of the FCT-ALE reference semantics.

The port's copy of ``fesom2_accelerate_tpu/ops/oracle_loops.py``, with
the same names and code: the port imports no jax, and runs where there is
none.  ``tests/test_torch_oracle.py`` holds it equal to the original.

This is the ground-truth anchor: a direct, unvectorized transcription of the
reference's staged CPU functions (reference src/reference.cpp:306-438) and,
for the stages the C++ skeleton left unfinished (b3, c — src/reference.cpp:11
has TODO placeholder indexing), of the Fortran specification embedded at
reference docs/refactoring.md:12-316.  O(N*L) Python loops — use on tiny
meshes only; the vectorized numpy oracle (oracle.py) and every accelerated
path are validated against this, mirroring the reference's
numpy-reference-vs-kernel methodology (kernels/fct_ale_a1.py:91).

Layout: level-major 2-D arrays ``[n_layers, N]`` (``fct_adf_v`` and ``area``
are ``[n_layers + 1, N]``), replacing the reference's flat
``entity * maxLevels + level`` indexing (src/reference.cpp:314) and its
``maxLevels + 1`` strided exceptions (src/reference.cpp:396,431).

Documented deviations from the reference (each is a pinned design decision):
  * 0-based indices everywhere; missing right triangle is ``-1`` (reference:
    1-based, ``<= 0`` sentinel, src/reference.cpp:411-413).
  * b2 multiplies by precomputed ``area_inv`` like the staged C++ reference
    (src/reference.cpp:432-434), not the Fortran's division
    (docs/refactoring.md:192-194); stage c also uses ``area_inv``.
"""

from __future__ import annotations

import numpy as np

from fesom2_accelerate_tpu_torch.mesh.topology import Mesh


def a1(mesh: Mesh, fct_LO, ttf, n_nodes=None):
    """Per-node max/min of low-order solution vs old tracer.

    Reference: src/reference.cpp:306-319 (and docs/refactoring.md:47-52).
    Computed over owned + halo nodes in the reference
    (src/fesom2-accelerate.cu:266); single-domain: all nodes.
    """
    L = mesh.n_layers
    N = n_nodes if n_nodes is not None else mesh.n_nodes
    fct_ttf_max = np.zeros((L, N), dtype=fct_LO.dtype)
    fct_ttf_min = np.zeros((L, N), dtype=fct_LO.dtype)
    for n in range(N):
        for z in range(mesh.nlev_nod[n] - 1):
            fct_ttf_max[z, n] = max(fct_LO[z, n], ttf[z, n])
            fct_ttf_min[z, n] = min(fct_LO[z, n], ttf[z, n])
    return fct_ttf_max, fct_ttf_min


def a2(mesh: Mesh, fct_ttf_max, fct_ttf_min, bignumber=1e3):
    """Admissible increments per element: max/min over its 3 nodes.

    Reference: src/reference.cpp:321-351.  Inactive levels are padded with
    -/+ bignumber through the full depth (src/reference.cpp:341-349) so they
    are transparent to a3's cluster reduction.  (We deliberately do NOT
    replicate the GPU kernel's one-level-short padding, reference
    kernels/fct_ale_a2.cu:19 — a documented reference inconsistency.)
    """
    L = mesh.n_layers
    E = mesh.n_elems
    dtype = fct_ttf_max.dtype
    UV_max = np.zeros((L, E), dtype=dtype)
    UV_min = np.zeros((L, E), dtype=dtype)
    for e in range(E):
        n0, n1, n2 = mesh.elem_nodes[e]
        for z in range(mesh.nlev_elem[e] - 1):
            UV_max[z, e] = max(
                fct_ttf_max[z, n0], fct_ttf_max[z, n1], fct_ttf_max[z, n2]
            )
            UV_min[z, e] = min(
                fct_ttf_min[z, n0], fct_ttf_min[z, n1], fct_ttf_min[z, n2]
            )
        for z in range(mesh.nlev_elem[e] - 1, L):
            UV_max[z, e] = -bignumber
            UV_min[z, e] = bignumber
    return UV_max, UV_min


def a3_vlimit1(mesh: Mesh, UV_max, UV_min, fct_LO, n_nodes=None):
    """Cluster bounds (vlimit=1): max/min over elements around each node,
    3-level vertical window, minus fct_LO.

    Reference: src/reference.cpp:353-392 (cluster + vertical window part);
    Fortran docs/refactoring.md:77-108.
    """
    L = mesh.n_layers
    N = n_nodes if n_nodes is not None else mesh.n_nodes
    dtype = UV_max.dtype
    fct_ttf_max = np.zeros((L, N), dtype=dtype)
    fct_ttf_min = np.zeros((L, N), dtype=dtype)
    for n in range(N):
        nlev = mesh.nlev_nod[n]
        tvert_max = np.empty(L, dtype=dtype)
        tvert_min = np.empty(L, dtype=dtype)
        for z in range(nlev - 1):
            elems = [
                mesh.node_elems[n, k] for k in range(mesh.node_elems_num[n])
            ]
            tvert_max[z] = max(UV_max[z, e] for e in elems)
            tvert_min[z] = min(UV_min[z, e] for e in elems)
        fct_ttf_max[0, n] = tvert_max[0] - fct_LO[0, n]
        fct_ttf_min[0, n] = tvert_min[0] - fct_LO[0, n]
        for z in range(1, nlev - 2):
            fct_ttf_max[z, n] = (
                max(tvert_max[z - 1], tvert_max[z], tvert_max[z + 1])
                - fct_LO[z, n]
            )
            fct_ttf_min[z, n] = (
                min(tvert_min[z - 1], tvert_min[z], tvert_min[z + 1])
                - fct_LO[z, n]
            )
        z = nlev - 2
        fct_ttf_max[z, n] = tvert_max[z] - fct_LO[z, n]
        fct_ttf_min[z, n] = tvert_min[z] - fct_LO[z, n]
    return fct_ttf_max, fct_ttf_min


def _tvert(mesh: Mesh, UV_max, UV_min, n):
    """Shared cluster reduction for vlimit 2/3 (docs/refactoring.md:116-118)."""
    L = mesh.n_layers
    nlev = mesh.nlev_nod[n]
    tvert_max = np.empty(L, dtype=UV_max.dtype)
    tvert_min = np.empty(L, dtype=UV_max.dtype)
    elems = [mesh.node_elems[n, k] for k in range(mesh.node_elems_num[n])]
    for z in range(nlev - 1):
        tvert_max[z] = max(UV_max[z, e] for e in elems)
        tvert_min[z] = min(UV_min[z, e] for e in elems)
    return tvert_max, tvert_min


def a3_vlimit2(mesh: Mesh, UV_max, UV_min, fct_ttf_max_in, fct_LO,
               n_nodes=None):
    """vlimit=2: widen cluster bounds by the local vertical tracer window.

    Fortran docs/refactoring.md:113-128.  NOTE the Fortran computes BOTH the
    max and min windows from fct_ttf_max (line 121 uses fct_ttf_max inside
    minval) — we transcribe that faithfully.
    """
    L = mesh.n_layers
    N = n_nodes if n_nodes is not None else mesh.n_nodes
    dtype = UV_max.dtype
    out_max = np.zeros((L, N), dtype=dtype)
    out_min = np.zeros((L, N), dtype=dtype)
    for n in range(N):
        nlev = mesh.nlev_nod[n]
        tvert_max, tvert_min = _tvert(mesh, UV_max, UV_min, n)
        tmax = tvert_max.copy()
        tmin = tvert_min.copy()
        for z in range(1, nlev - 2):
            w = fct_ttf_max_in[z - 1 : z + 2, n]
            tmax[z] = max(tvert_max[z], w.max())
            tmin[z] = min(tvert_min[z], w.min())
        for z in range(nlev - 1):
            out_max[z, n] = tmax[z] - fct_LO[z, n]
            out_min[z, n] = tmin[z] - fct_LO[z, n]
    return out_max, out_min


def a3_vlimit3(mesh: Mesh, UV_max, UV_min, fct_ttf_max_in, fct_LO,
               n_nodes=None):
    """vlimit=3: narrow cluster bounds by the local vertical tracer window.

    Fortran docs/refactoring.md:133-148 (same fct_ttf_max-for-both note as
    vlimit=2, line 141)."""
    L = mesh.n_layers
    N = n_nodes if n_nodes is not None else mesh.n_nodes
    dtype = UV_max.dtype
    out_max = np.zeros((L, N), dtype=dtype)
    out_min = np.zeros((L, N), dtype=dtype)
    for n in range(N):
        nlev = mesh.nlev_nod[n]
        tvert_max, tvert_min = _tvert(mesh, UV_max, UV_min, n)
        tmax = tvert_max.copy()
        tmin = tvert_min.copy()
        for z in range(1, nlev - 2):
            w = fct_ttf_max_in[z - 1 : z + 2, n]
            tmax[z] = min(tvert_max[z], w.max())
            tmin[z] = max(tvert_min[z], w.min())
        for z in range(nlev - 1):
            out_max[z, n] = tmax[z] - fct_LO[z, n]
            out_min[z, n] = tmin[z] - fct_LO[z, n]
    return out_max, out_min


def b1_vertical(mesh: Mesh, fct_adf_v, n_nodes=None):
    """Vertical flux splitting into fct_plus/fct_minus (overwrites).

    Reference: src/reference.cpp:393-399 (fused into a3 there);
    Fortran docs/refactoring.md:156-169."""
    L = mesh.n_layers
    N = n_nodes if n_nodes is not None else mesh.n_nodes
    dtype = fct_adf_v.dtype
    fct_plus = np.zeros((L, N), dtype=dtype)
    fct_minus = np.zeros((L, N), dtype=dtype)
    for n in range(N):
        for z in range(mesh.nlev_nod[n] - 1):
            fct_plus[z, n] = max(0.0, fct_adf_v[z, n]) + max(
                0.0, -fct_adf_v[z + 1, n]
            )
            fct_minus[z, n] = min(0.0, fct_adf_v[z, n]) + min(
                0.0, -fct_adf_v[z + 1, n]
            )
    return fct_plus, fct_minus


def b1_horizontal(mesh: Mesh, fct_plus, fct_minus, fct_adf_h):
    """Edge->node scatter of split horizontal fluxes (accumulates in place).

    Reference: src/reference.cpp:406-425; the GPU version is the atomicAdd
    hot spot (kernels/fct_ale_b1_horizontal.cu:24-27)."""
    fct_plus = fct_plus.copy()
    fct_minus = fct_minus.copy()
    for ed in range(mesh.n_edges):
        n1, n2 = mesh.edges[ed]
        for z in range(mesh.nlev_edge[ed]):
            adfh = fct_adf_h[z, ed]
            fct_plus[z, n1] += max(0.0, adfh)
            fct_minus[z, n1] += min(0.0, adfh)
            fct_plus[z, n2] += max(0.0, -adfh)
            fct_minus[z, n2] += min(0.0, -adfh)
    return fct_plus, fct_minus


def b2(mesh: Mesh, fct_plus, fct_minus, fct_ttf_max, fct_ttf_min,
       dt, flux_eps=1e-16, n_nodes=None):
    """Zalesak limiting factors (in place -> limiter factors in [.,1]).

    Reference: src/reference.cpp:426-437 (area_inv form)."""
    N = n_nodes if n_nodes is not None else mesh.n_nodes
    fct_plus = fct_plus.copy()
    fct_minus = fct_minus.copy()
    for n in range(N):
        for z in range(mesh.nlev_nod[n] - 1):
            flux = fct_plus[z, n] * dt * mesh.area_inv[z, n] + flux_eps
            fct_plus[z, n] = min(1.0, fct_ttf_max[z, n] / flux)
            flux = fct_minus[z, n] * dt * mesh.area_inv[z, n] - flux_eps
            fct_minus[z, n] = min(1.0, fct_ttf_min[z, n] / flux)
    return fct_plus, fct_minus


def b3_vertical(mesh: Mesh, fct_plus, fct_minus, fct_adf_v, iter_yn=False,
                n_nodes=None):
    """Apply limiter to vertical antidiffusive fluxes (in place).

    Fortran docs/refactoring.md:204-233 (kernel b3_vertical.cu).  Surface
    level uses only the level-0 factors; deeper levels couple z-1 and z; the
    bottom flux is implicitly zero.  With iter_yn, the residual flux
    (1-ae)*f goes to fct_adf_v2 for levels >= 1 only (Fortran:227-229)."""
    L = mesh.n_layers
    N = n_nodes if n_nodes is not None else mesh.n_nodes
    fct_adf_v = fct_adf_v.copy()
    fct_adf_v2 = np.zeros_like(fct_adf_v) if iter_yn else None
    for n in range(N):
        ae = 1.0
        flux = fct_adf_v[0, n]
        if flux >= 0.0:
            ae = min(ae, fct_plus[0, n])
        else:
            ae = min(ae, fct_minus[0, n])
        fct_adf_v[0, n] = ae * flux
        for z in range(1, mesh.nlev_nod[n] - 1):
            ae = 1.0
            flux = fct_adf_v[z, n]
            if flux >= 0.0:
                ae = min(ae, fct_minus[z - 1, n])
                ae = min(ae, fct_plus[z, n])
            else:
                ae = min(ae, fct_plus[z - 1, n])
                ae = min(ae, fct_minus[z, n])
            if iter_yn:
                fct_adf_v2[z, n] = (1.0 - ae) * flux
            fct_adf_v[z, n] = ae * flux
    if iter_yn:
        return fct_adf_v, fct_adf_v2
    return fct_adf_v


def b3_horizontal(mesh: Mesh, fct_plus, fct_minus, fct_adf_h, iter_yn=False):
    """Apply limiter to horizontal antidiffusive fluxes (in place).

    Fortran docs/refactoring.md:238-263 (kernel b3_horizontal.cu)."""
    fct_adf_h = fct_adf_h.copy()
    fct_adf_h2 = np.zeros_like(fct_adf_h) if iter_yn else None
    for ed in range(mesh.n_edges):
        n1, n2 = mesh.edges[ed]
        for z in range(mesh.nlev_edge[ed]):
            ae = 1.0
            flux = fct_adf_h[z, ed]
            if flux >= 0.0:
                ae = min(ae, fct_plus[z, n1])
                ae = min(ae, fct_minus[z, n2])
            else:
                ae = min(ae, fct_minus[z, n1])
                ae = min(ae, fct_plus[z, n2])
            if iter_yn:
                fct_adf_h2[z, ed] = (1.0 - ae) * flux
            fct_adf_h[z, ed] = ae * flux
    if iter_yn:
        return fct_adf_h, fct_adf_h2
    return fct_adf_h


def c_update_solution(mesh: Mesh, ttf, hnode, hnode_new, fct_LO,
                      fct_adf_v, fct_adf_h,
                      del_ttf_advvert, del_ttf_advhoriz, dt, n_nodes=None):
    """Non-iterative stage c: solution increments.

    Fortran docs/refactoring.md:295-314 (the authoritative form; the C++
    skeleton's sign at src/reference.cpp:264 is a known bug — it subtracts
    the whole expression).  Kernels fct_ale_c_vertical.cu /
    c_horizontal.cu exist in the reference but were never wired into a
    phase driver (SURVEY §2.2 K10/K11)."""
    N = n_nodes if n_nodes is not None else mesh.n_nodes
    del_v = del_ttf_advvert.copy()
    del_h = del_ttf_advhoriz.copy()
    for n in range(N):
        for z in range(mesh.nlev_nod[n] - 1):
            del_v[z, n] = (
                del_v[z, n]
                - ttf[z, n] * hnode[z, n]
                + fct_LO[z, n] * hnode_new[z, n]
                + (fct_adf_v[z, n] - fct_adf_v[z + 1, n])
                * dt
                * mesh.area_inv[z, n]
            )
    for ed in range(mesh.n_edges):
        n1, n2 = mesh.edges[ed]
        for z in range(mesh.nlev_edge[ed]):
            del_h[z, n1] += fct_adf_h[z, ed] * dt * mesh.area_inv[z, n1]
            del_h[z, n2] -= fct_adf_h[z, ed] * dt * mesh.area_inv[z, n2]
    return del_v, del_h


def c_update_LO(mesh: Mesh, fct_LO, fct_adf_v, fct_adf_h, hnode_new, dt,
                n_nodes=None):
    """Iterative stage c: update fct_LO for the next FCT iteration.

    Fortran docs/refactoring.md:269-286."""
    N = n_nodes if n_nodes is not None else mesh.n_nodes
    fct_LO = fct_LO.copy()
    for n in range(N):
        for z in range(mesh.nlev_nod[n] - 1):
            fct_LO[z, n] += (
                (fct_adf_v[z, n] - fct_adf_v[z + 1, n])
                * dt
                * mesh.area_inv[z, n]
                / hnode_new[z, n]
            )
    for ed in range(mesh.n_edges):
        n1, n2 = mesh.edges[ed]
        for z in range(mesh.nlev_edge[ed]):
            fct_LO[z, n1] += (
                fct_adf_h[z, ed] * dt * mesh.area_inv[z, n1]
                / hnode_new[z, n1]
            )
            fct_LO[z, n2] -= (
                fct_adf_h[z, ed] * dt * mesh.area_inv[z, n2]
                / hnode_new[z, n2]
            )
    return fct_LO


def fct_ale_step(mesh: Mesh, fields: dict, vlimit=1, iter_yn=False,
                 dt=1.0, flux_eps=1e-16, bignumber=1e3) -> dict:
    """Full a->b->c chain, mirroring the Fortran driver structure
    (docs/refactoring.md:13-315).  Returns a dict of all outputs."""
    ttf = fields["ttf"]
    fct_LO = fields["fct_LO"]
    tmax, tmin = a1(mesh, fct_LO, ttf)
    UV_max, UV_min = a2(mesh, tmax, tmin, bignumber)
    if vlimit == 1:
        tmax2, tmin2 = a3_vlimit1(mesh, UV_max, UV_min, fct_LO)
    elif vlimit == 2:
        tmax2, tmin2 = a3_vlimit2(mesh, UV_max, UV_min, tmax, fct_LO)
    else:
        tmax2, tmin2 = a3_vlimit3(mesh, UV_max, UV_min, tmax, fct_LO)
    fct_plus, fct_minus = b1_vertical(mesh, fields["fct_adf_v"])
    fct_plus, fct_minus = b1_horizontal(
        mesh, fct_plus, fct_minus, fields["fct_adf_h"]
    )
    fct_plus, fct_minus = b2(
        mesh, fct_plus, fct_minus, tmax2, tmin2, dt, flux_eps
    )
    # [multi-domain: halo exchange of fct_plus/fct_minus happens here,
    #  docs/refactoring.md:199-200]
    if iter_yn:
        adf_v, adf_v2 = b3_vertical(
            mesh, fct_plus, fct_minus, fields["fct_adf_v"], iter_yn=True
        )
        adf_h, adf_h2 = b3_horizontal(
            mesh, fct_plus, fct_minus, fields["fct_adf_h"], iter_yn=True
        )
        new_LO = c_update_LO(
            mesh, fct_LO, adf_v, adf_h, fields["hnode_new"], dt
        )
        return dict(
            fct_ttf_max=tmax2, fct_ttf_min=tmin2,
            fct_plus=fct_plus, fct_minus=fct_minus,
            fct_adf_v=adf_v2, fct_adf_h=adf_h2,  # swapped for next iteration
            fct_adf_v_limited=adf_v, fct_adf_h_limited=adf_h,
            fct_LO=new_LO,
        )
    adf_v = b3_vertical(mesh, fct_plus, fct_minus, fields["fct_adf_v"])
    adf_h = b3_horizontal(mesh, fct_plus, fct_minus, fields["fct_adf_h"])
    del_v, del_h = c_update_solution(
        mesh, ttf, fields["hnode"], fields["hnode_new"], fct_LO,
        adf_v, adf_h,
        fields["del_ttf_advvert"], fields["del_ttf_advhoriz"], dt,
    )
    return dict(
        fct_ttf_max=tmax2, fct_ttf_min=tmin2,
        fct_plus=fct_plus, fct_minus=fct_minus,
        fct_adf_v=adf_v, fct_adf_h=adf_h,
        del_ttf_advvert=del_v, del_ttf_advhoriz=del_h,
    )


def stress2rhs(mesh_elem_nodes, elem_area, ice_strength, sigma11, sigma12,
               sigma22, gradient_sca, metric_factor, inv_areamass,
               rhs_a, rhs_m, n_nodes):
    """Sea-ice EVP stress divergence (element->node scatter), loop form.

    Reference: src/reference.cpp:440-480 / Fortran docs/refactoring.md:409-461.
    ``gradient_sca`` is [6, E] (coefficients k and k+3 per local node)."""
    U = np.zeros(n_nodes, dtype=sigma11.dtype)
    V = np.zeros(n_nodes, dtype=sigma11.dtype)
    one_third = 1.0 / 3.0
    for e in range(mesh_elem_nodes.shape[0]):
        if ice_strength[e] > 0.0:
            for k in range(3):
                n = mesh_elem_nodes[e, k]
                U[n] -= elem_area[e] * (
                    sigma11[e] * gradient_sca[k, e]
                    + sigma12[e] * gradient_sca[k + 3, e]
                    + sigma12[e] * one_third * metric_factor[e]
                )
                V[n] -= elem_area[e] * (
                    sigma12[e] * gradient_sca[k, e]
                    + sigma22[e] * gradient_sca[k + 3, e]
                    - sigma11[e] * one_third * metric_factor[e]
                )
    for n in range(n_nodes):
        if inv_areamass[n] > 0.0:
            U[n] = U[n] * inv_areamass[n] + rhs_a[n]
            V[n] = V[n] * inv_areamass[n] + rhs_m[n]
        else:
            U[n] = 0.0
            V[n] = 0.0
    return U, V
