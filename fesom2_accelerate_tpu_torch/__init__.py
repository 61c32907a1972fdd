"""fesom2_accelerate_tpu_torch: the FCT-ALE tracer limiter and the sea-ice
EVP stress divergence in PyTorch, with hand-written CUDA kernels for one
NVIDIA H100.

A port of the JAX package ``fesom2_accelerate_tpu`` beside it, which stays
the reference.  The module layout and names follow the JAX package, so each
module has its counterpart there.  This package imports torch and numpy and
never jax: it carries its own copy of the numpy mesh code (planar and
cylinder generators, RCM ordering, the FESOM2 mesh-file reader).

* ``FctAleSolver(mesh, cfg, device="cuda")`` runs the step as
  hand-written CUDA kernels (``ops/cuda/``): K1 bounds -> K2 limit -> K34
  update_fused by default, or another form with ``fuse_k12`` (K12
  limit_fused in place of K1 -> K2) and ``fuse_k34=False`` (K3 b3h -> K4
  update in place of K34);
* ``backend="torch"`` runs the plain PyTorch stages on any device (the
  float64 correctness gate), and is what a solver on the CPU runs: every
  solver's default backend, None, follows its ``device`` (or ``devices``),
  "cuda" on CUDA devices and "torch" on the CPU;
* ``utils/tuning.py`` sweeps the kernels' block sizes and the step's
  forms on a card, each configuration validated first
  (``python -m fesom2_accelerate_tpu_torch.utils.tune``);
* ``Stress2RhsSolver(mesh, dtype, device=...)`` runs stress2rhs through
  the H-S2R CUDA kernel or in plain PyTorch;
* ``ShardedFctAleSolver(mesh, cfg, devices=[...])``
  runs the FCT step on ``partition_mesh``'s parts, one per entry of
  ``devices`` (several may share one card), with a halo exchange between
  K2 and the b3 horizontal limiting (``parallel/``).
"""

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import (
    Mesh,
    generate_cylinder_mesh,
    generate_planar_mesh,
    read_fesom_mesh,
)
from fesom2_accelerate_tpu_torch.model import FctAleSolver, Stress2RhsSolver
from fesom2_accelerate_tpu_torch.parallel import (
    ShardedFctAleSolver,
    partition_mesh,
)

__all__ = [
    "FctAleConfig",
    "FctAleSolver",
    "Mesh",
    "ShardedFctAleSolver",
    "Stress2RhsSolver",
    "generate_cylinder_mesh",
    "generate_planar_mesh",
    "partition_mesh",
    "read_fesom_mesh",
]
