"""Sea-ice EVP stress divergence solver (the second workload), PyTorch port.

Counterpart of ``fesom2_accelerate_tpu/model/stress2rhs.py``.  FESOM2 calls
``stress2rhs`` once per EVP subcycle, many times per ocean step: the
element stresses change every substep, the node rows (``inv_areamass``,
``rhs_a``, ``rhs_m``) feed the momentum update.  The solver keeps the mesh
tensors on one explicit device and runs one of two functions over an
element slab:

* ``backend="cuda"``: the hand-written H-S2R kernel
  (:func:`~fesom2_accelerate_tpu_torch.ops.cuda.kernels.stress2rhs`,
  ``ops/cuda/csrc/stress2rhs.cu``); CUDA devices only;
* ``backend="torch"``: :func:`~fesom2_accelerate_tpu_torch.ops.cuda.kernels.
  stress2rhs_ref`, plain PyTorch, any device, float32 or float64.

The default, ``backend=None``, follows ``device``: "cuda" on a CUDA
device, "torch" on the CPU (:func:`~fesom2_accelerate_tpu_torch.config.
resolve_backend`).

The slab (:meth:`Stress2RhsSolver.pack_elem_inputs`) is SoA
``[11, E]`` in natural element order, rows s11, s12, s22,
``area * (ice_strength > 0)``, ``metric_factor / 3`` and ``gradient_sca``
rows 0..5: the rows of the JAX package's slab, without its home-slot
permutation and zero pad rows.  SoA keeps the packing a plain stack of
the caller's element rows and keeps each row contiguous for the plain
version; the kernel's gathers read neighbouring elements per row, which
the mesh numbering keeps close.  An AoS slab would cut the sectors per
gathered element and is left to tuning.

The JAX solver's ``tile`` and ``form`` arguments choose TPU layouts (tile
width, one-hot vs packed home-slot scatter).  They have no meaning on
Hopper, where one gather kernel serves every mesh ordering, and are left
out.
"""

from __future__ import annotations

import torch

from fesom2_accelerate_tpu_torch.config import resolve_backend
from fesom2_accelerate_tpu_torch.mesh.topology import Mesh
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data


class Stress2RhsSolver:
    """Owns the mesh tensors on one device and the stress2rhs function.

    Usage::

        solver = Stress2RhsSolver(mesh, torch.float32, device="cuda")
        U, V = solver(elem_area, ice_strength, sigma11, sigma12, sigma22,
                      gradient_sca, metric_factor, inv_areamass, rhs_a,
                      rhs_m)
        # EVP subcycles: pack the element inputs once, then per substep
        packed = solver.pack_elem_inputs(elem_area, ice_strength, sigma11,
                                         sigma12, sigma22, gradient_sca,
                                         metric_factor)
        U, V = solver.call_packed(packed, inv_areamass, rhs_a, rhs_m)

    Inputs are numpy arrays or tensors: element rows ``[E]``,
    ``gradient_sca`` ``[6, E]``, node rows ``[N]``; they are converted to
    the solver's dtype and device.  Outputs are ``[N]`` tensors.

    backend: None (the default: "cuda" on a CUDA ``device``, "torch" on
    the CPU), "torch" (plain PyTorch, any device) or "cuda" (H-S2R;
    ``device`` must be a CUDA device)."""

    def __init__(self, mesh: Mesh, dtype: torch.dtype = torch.float32,
                 backend: str | None = None, *,
                 device: torch.device | str):
        device = torch.device(device)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or "
                             f"torch.float64, got {dtype}")
        backend = resolve_backend(backend, device)
        self._fn = (kernels.stress2rhs if backend == "cuda"
                    else kernels.stress2rhs_ref)
        self.mesh = mesh
        self.dtype = dtype
        self.backend = backend
        self.device = device
        self.md = build_mesh_data(mesh, dtype, device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def pack_elem_inputs(self, elem_area, ice_strength, sigma11, sigma12,
                         sigma22, gradient_sca, metric_factor):
        """Element inputs -> the ``[11, E]`` slab.  Pack once, then drive
        :meth:`call_packed` per EVP substep."""
        area, ice, s11, s12, s22, grad, mf = (
            self._tensor(a) for a in (elem_area, ice_strength, sigma11,
                                      sigma12, sigma22, gradient_sca,
                                      metric_factor))
        ea = torch.where(ice > 0.0, area, 0.0)
        return torch.cat([torch.stack([s11, s12, s22, ea, mf / 3.0]), grad],
                         dim=0).contiguous()

    def call_packed(self, packed, inv_areamass, rhs_a, rhs_m):
        """One stress2rhs call on a packed slab -> (U, V)."""
        return self._fn(self.md, packed, self._tensor(inv_areamass),
                        self._tensor(rhs_a), self._tensor(rhs_m))

    def __call__(self, elem_area, ice_strength, sigma11, sigma12, sigma22,
                 gradient_sca, metric_factor, inv_areamass, rhs_a, rhs_m):
        packed = self.pack_elem_inputs(elem_area, ice_strength, sigma11,
                                       sigma12, sigma22, gradient_sca,
                                       metric_factor)
        return self.call_packed(packed, inv_areamass, rhs_a, rhs_m)
