"""Runtime configuration for the FCT-ALE solver (PyTorch port).

Counterpart of ``fesom2_accelerate_tpu/config.py``: the same fields and
checks, with ``dtype`` a ``torch.dtype``.  The reference threads these
switches through every call as bare scalars (``vlimit`` 1/2/3, ``iter_yn``,
``flux_eps``, ``bignumber``, ``dt``; reference docs/refactoring.md:32-35).
:func:`resolve_backend` is the solvers' choice of backend from their
devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class FctAleConfig:
    """Static configuration of one FCT-ALE solve.

    Attributes:
      vlimit: vertical-limiting variant, 1/2/3 (1 is the reference's
        production path, src/reference.cpp:297).
      iter_yn: iterative-FCT flag.  When true, stage c updates ``fct_LO``
        and swaps in the residual antidiffusive fluxes instead of producing
        solution increments (docs/refactoring.md:227-229,265-290).
      flux_eps: guard epsilon in the Zalesak limiter denominator.
      bignumber: sentinel padding inactive element levels in stage a2 so
        they are transparent to max/min reductions.
      dt: timestep.
      dtype: ``torch.float64`` (the correctness gate, the reference's
        ``real_type = double``) or ``torch.float32`` (the performance path).
    """

    vlimit: int = 1
    iter_yn: bool = False
    flux_eps: float = 1e-16
    bignumber: float = 1e3
    dt: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        if self.vlimit not in (1, 2, 3):
            raise ValueError(f"vlimit must be 1, 2 or 3, got {self.vlimit}")
        if self.dtype not in _DTYPES:
            raise ValueError(
                f"dtype must be torch.float32 or torch.float64, got "
                f"{self.dtype}")

    @property
    def np_dtype(self):
        return np.dtype(_DTYPES[self.dtype])


BACKENDS = ("torch", "cuda")


def resolve_backend(backend: str | None, devices) -> str:
    """The backend a solver on ``devices`` (one device or a list) runs.

    ``None``, the solvers' default, follows the devices the caller gave:
    "cuda" (the hand-written kernels) when every device is a CUDA device,
    "torch" (the plain PyTorch stages) when every one is the CPU; a mix, or
    any other device type, raises.  Nothing probes for a card.  An explicit
    "torch" runs on any device; an explicit "cuda" needs CUDA devices."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices}
    if backend is None:
        if kinds == {"cuda"}:
            return "cuda"
        if kinds == {"cpu"}:
            return "torch"
        raise ValueError(
            f"backend=None follows the devices, which must be all CUDA or "
            f"all CPU, got {[str(d) for d in devices]}; pass backend= to "
            f"choose")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be 'torch' or 'cuda' (or None), got "
                         f"{backend!r}")
    if backend == "cuda" and kinds != {"cuda"}:
        raise ValueError(f"backend='cuda' needs CUDA devices, got "
                         f"{[str(d) for d in devices]}")
    return backend
