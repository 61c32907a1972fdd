"""fesom2_accelerate_tpu_torch: the FCT-ALE tracer limiter and the sea-ice
EVP stress divergence in PyTorch, with hand-written CUDA kernels for one
NVIDIA H100.

A port of the JAX package ``fesom2_accelerate_tpu`` beside it, which stays
the reference.  The module layout and names follow the JAX package, so each
module has its counterpart there.  This package imports torch and numpy and
never jax: it carries its own copy of the numpy mesh code (planar and
cylinder generators, RCM ordering, the FESOM2 mesh-file reader).

* ``FctAleSolver(mesh, cfg, device="cuda")`` runs the step as
  hand-written CUDA kernels (``ops/cuda/``): K12 limit_fused -> K3 b3h ->
  K4 update by default, or another form with ``fuse_k12=False`` (K1
  bounds -> K2 limit in place of K12) and ``fuse_k34=True`` (K34
  update_fused in place of K3 -> K4);
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
  K2 and the b3 horizontal limiting (``parallel/``); with
  ``devices=distributed.global_devices(...)`` the parts spread over
  processes (``parallel/distributed.py``, ``torch.distributed``), as a
  FESOM2 run's MPI ranks hold them;
* ``host_embed.py`` and ``native/fesom2_torch_host.cpp`` are the C ABI a
  Fortran or C host calls (the JAX shim's ``f2t_*_`` surface);
* the solvers' ``run`` (and ``run_tracers``) replay the steps as CUDA
  graphs on the "cuda" backend where the host, not the card, sets the
  pace of a step (``runtime/graphs.py``, the counterpart of the JAX
  ``lax.scan``), and ``runtime/checkpoint.py`` saves and loads a
  state in the JAX package's npz format: the sharded solver's
  ``save_checkpoint`` / ``load_checkpoint`` resume at any partition.
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
