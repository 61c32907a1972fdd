"""fesom2_accelerate_tpu_torch: the FCT-ALE tracer limiter in PyTorch, with
hand-written CUDA kernels for one NVIDIA H100.

A port of the JAX package ``fesom2_accelerate_tpu`` beside it, which stays
the reference.  The module layout and names follow the JAX package, so each
module has its counterpart there.  This package imports torch and numpy and
never jax: it carries its own copy of the numpy mesh code.

* ``FctAleSolver(mesh, cfg, backend="torch", device=...)`` runs the plain
  PyTorch stages on any device (the float64 correctness gate);
* ``backend="cuda"`` runs the step as three CUDA kernels (K1 bounds,
  K2 limit, K34 update_fused; ``ops/cuda/``) on a CUDA device.
"""

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import Mesh, generate_planar_mesh
from fesom2_accelerate_tpu_torch.model import FctAleSolver

__all__ = [
    "FctAleConfig",
    "FctAleSolver",
    "Mesh",
    "generate_planar_mesh",
]
