"""The plain reference of the sea-ice EVP stress divergence (``stress2rhs``).

FESOM2's ``stress2rhs`` (``ice_EVP.F90``, as the reference library states
it): each element's stresses times its basis-function gradients, summed
into its three nodes, over the node's ice-covered incident elements; a
node with mass divides by it and adds its right-hand side.  Written as a
gather over the node -> element incidence of
:mod:`portbench.reference.mesh`; any float dtype and device.
"""

from __future__ import annotations

import torch

from portbench.reference.mesh import RefMesh


def stress2rhs(mesh: RefMesh, elem_area, ice_strength, sigma11, sigma12,
               sigma22, gradient_sca, metric_factor, inv_areamass, rhs_a,
               rhs_m) -> tuple:
    """(U, V) [N] from element rows [E], ``gradient_sca`` [6, E] and node
    rows [N], all tensors of one dtype on one device."""
    dev = elem_area.device
    ne = torch.as_tensor(mesh.node_elems, dtype=torch.int64, device=dev)
    idx = ne.clamp(min=0)
    pos = torch.as_tensor(mesh.node_elems_pos, dtype=torch.int64,
                          device=dev).clamp(min=0)
    live = (torch.arange(ne.shape[1], device=dev)[None]
            < torch.as_tensor(mesh.node_elems_num, dtype=torch.int64,
                              device=dev)[:, None])
    active = live & (ice_strength[idx] > 0.0)
    g_k = gradient_sca[pos, idx]
    g_k3 = gradient_sca[pos + 3, idx]
    ea = elem_area[idx]
    s11, s12, s22 = sigma11[idx], sigma12[idx], sigma22[idx]
    mf3 = metric_factor[idx] * (1.0 / 3.0)
    u = torch.where(active, -ea * (s11 * g_k + s12 * g_k3 + s12 * mf3),
                    0.0).sum(dim=1)
    v = torch.where(active, -ea * (s12 * g_k + s22 * g_k3 - s11 * mf3),
                    0.0).sum(dim=1)
    mass = inv_areamass > 0.0
    return (torch.where(mass, u * inv_areamass + rhs_a, 0.0),
            torch.where(mass, v * inv_areamass + rhs_m, 0.0))
