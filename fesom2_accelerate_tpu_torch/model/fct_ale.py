"""Single-device FCT-ALE solver (PyTorch port).

Counterpart of ``fesom2_accelerate_tpu/model/fct_ale.py``.  The phase split
of the reference (src/fesom2-accelerate.cu:258-379) survives as
``pre_comm`` / ``inter_comm`` / ``post_comm``, the places where a sharded
run inserts its halo exchange (docs/refactoring.md:200,235).  The solver
keeps the mesh tensors on one explicit device and runs one of two step
functions over state tensors on that device:

* ``backend="cuda"``: :func:`~fesom2_accelerate_tpu_torch.ops.cuda.step.
  fct_ale_step_cuda`, hand-written CUDA kernels; CUDA devices only.  The
  keywords ``fuse_k12`` and ``fuse_k34`` choose its form (K12 or K1 -> K2,
  K34 or K3 -> K4), the counterparts of the JAX package's
  ``build_pallas_data(fuse_k12=, fuse_k34=)``;
* ``backend="torch"``: :func:`fct_ale_step`, plain PyTorch stages, any
  device, float32 or float64 (the correctness gate).

The default, ``backend=None``, follows ``device``: "cuda" on a CUDA
device, "torch" on the CPU (:func:`~fesom2_accelerate_tpu_torch.config.
resolve_backend`), as the JAX solver's default "xla" is compiled for the
device it runs on.

Multi-tracer batching (``init_state_tracers`` / ``step_tracers`` /
``run_tracers``, the JAX solver's methods of the same names) runs Tb
tracers through one chain of kernel launches: each per-tracer field with a
leading tracer axis, ``hnode``/``hnode_new`` shared.  As in the JAX
package, where only ``backend="pallas"`` batches, it is ``backend="cuda"``
only (:func:`~fesom2_accelerate_tpu_torch.ops.cuda.step.
fct_ale_step_cuda_batched`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig, resolve_backend
from fesom2_accelerate_tpu_torch.mesh.topology import Mesh
from fesom2_accelerate_tpu_torch.ops import stages
from fesom2_accelerate_tpu_torch.ops.cuda.step import (
    fct_ale_step_cuda,
    fct_ale_step_cuda_batched,
)
from fesom2_accelerate_tpu_torch.ops.meshdata import (
    MeshData,
    build_mesh_data,
    check_edge_order,
)


def pre_comm(md: MeshData, cfg: FctAleConfig, ttf, fct_LO, fct_adf_v,
             fct_adf_h):
    """Stages a1..b2 -> limiter factors (reference
    fct_ale_pre_comm_acc_, src/fesom2-accelerate.cu:258-340)."""
    tmax, tmin = stages.a1(md, fct_LO, ttf)
    if cfg.vlimit == 1:
        # fused a2+a3: the element-cluster reduce collapses to a node-
        # neighbour max over incident edges (stages.a3_vlimit1_fused)
        tmax2, tmin2 = stages.a3_vlimit1_fused(md, tmax, tmin, fct_LO)
    else:
        UV_max, UV_min = stages.a2(md, tmax, tmin, cfg.bignumber)
        tmax2, tmin2 = stages.a3(md, UV_max, UV_min, tmax, fct_LO,
                                 cfg.vlimit)
    fct_plus, fct_minus = stages.b1_vertical(md, fct_adf_v)
    fct_plus, fct_minus = stages.b1_horizontal(
        md, fct_plus, fct_minus, fct_adf_h
    )
    fct_plus, fct_minus = stages.b2(
        md, fct_plus, fct_minus, tmax2, tmin2, cfg.dt, cfg.flux_eps
    )
    return dict(
        fct_ttf_max=tmax2, fct_ttf_min=tmin2,
        fct_plus=fct_plus, fct_minus=fct_minus,
    )


def inter_comm(md: MeshData, cfg: FctAleConfig, fct_plus, fct_minus,
               fct_adf_v):
    """b3 vertical: node-local work the reference overlaps with the MPI
    wait (fct_ale_inter_comm_acc_, src/fesom2-accelerate.cu:342-356)."""
    return stages.b3_vertical(md, fct_plus, fct_minus, fct_adf_v, cfg.iter_yn)


def post_comm(md: MeshData, cfg: FctAleConfig, fct_plus, fct_minus,
              fct_adf_h):
    """b3 horizontal, after exchanged limiter factors are available
    (fct_ale_post_comm_acc_, src/fesom2-accelerate.cu:358-379)."""
    return stages.b3_horizontal(
        md, fct_plus, fct_minus, fct_adf_h, cfg.iter_yn
    )


def fct_ale_step(md: MeshData, cfg: FctAleConfig, state: dict) -> dict:
    """Full a->b->c chain on one device.  ``state`` carries the fields of
    :func:`fesom2_accelerate_tpu_torch.mesh.generate.random_fields` as
    tensors on the mesh data's device."""
    lim = pre_comm(md, cfg, state["ttf"], state["fct_LO"],
                   state["fct_adf_v"], state["fct_adf_h"])
    vert = inter_comm(md, cfg, lim["fct_plus"], lim["fct_minus"],
                      state["fct_adf_v"])
    horiz = post_comm(md, cfg, lim["fct_plus"], lim["fct_minus"],
                      state["fct_adf_h"])
    return update_step(md, cfg, state, lim, vert, horiz)


def update_step(md: MeshData, cfg: FctAleConfig, state: dict, lim: dict,
                vert: tuple, horiz: tuple) -> dict:
    """Stage c and the step's output dict, from ``pre_comm``'s output and
    the (limited, residual) flux pairs of ``inter_comm`` and
    ``post_comm``."""
    adf_v, adf_v2 = vert
    adf_h, adf_h2 = horiz
    out = dict(state)
    out.update(
        fct_ttf_max=lim["fct_ttf_max"], fct_ttf_min=lim["fct_ttf_min"],
        fct_plus=lim["fct_plus"], fct_minus=lim["fct_minus"],
    )
    if cfg.iter_yn:
        new_LO = stages.c_update_LO(
            md, state["fct_LO"], adf_v, adf_h, state["hnode_new"], cfg.dt
        )
        # swap in the residual fluxes for the next FCT iteration
        # (docs/refactoring.md:287-289)
        out.update(
            fct_LO=new_LO, fct_adf_v=adf_v2, fct_adf_h=adf_h2,
            fct_adf_v_limited=adf_v, fct_adf_h_limited=adf_h,
        )
    else:
        del_v, del_h = stages.c_update_solution(
            md, state["ttf"], state["hnode"], state["hnode_new"],
            state["fct_LO"], adf_v, adf_h,
            state["del_ttf_advvert"], state["del_ttf_advhoriz"], cfg.dt,
        )
        out.update(
            fct_adf_v=adf_v, fct_adf_h=adf_h,
            del_ttf_advvert=del_v, del_ttf_advhoriz=del_h,
        )
    return out


class FctAleSolver:
    """Owns the mesh tensors on one device and the step function.

    Usage::

        solver = FctAleSolver(mesh, FctAleConfig(), device="cuda")
        state = solver.init_state(fields)      # host numpy -> device
        state = solver.step(state)             # one FCT-ALE step
        state = solver.run(state, n_steps=10)  # Python loop of steps
        # Tb tracers: per-tracer fields [Tb, ...], hnode/hnode_new [L, N]
        batch = solver.run_tracers(solver.init_state_tracers(fields_tb), 10)

    backend: None (the default: "cuda" on a CUDA ``device``, "torch" on
    the CPU), "torch" (plain PyTorch stages, any device and float dtype)
    or "cuda" (the CUDA kernels; ``device`` must be a CUDA device).  With
    "cuda", ``fuse_k12`` runs K1 and K2 as the one kernel K12 and
    ``fuse_k34=False`` runs K3 -> K4 in place of K34; "torch" refuses any
    value but the default.  A CUDA solver whose form runs K34 needs the
    mesh's edges sorted by first endpoint (``MeshData.ed_ptr``) and raises
    at construction otherwise.  The tracer methods need "cuda" and the
    default ``fuse_k12=False``."""

    def __init__(self, mesh: Mesh, cfg: FctAleConfig = FctAleConfig(),
                 backend: str | None = None, *,
                 device: torch.device | str, fuse_k12: bool = False,
                 fuse_k34: bool = True):
        device = torch.device(device)
        backend = resolve_backend(backend, device)
        if backend == "torch":
            if (fuse_k12, fuse_k34) != (False, True):
                raise ValueError(
                    "fuse_k12 and fuse_k34 choose the form of "
                    "backend='cuda'; backend='torch' takes the defaults")
            self._step_fn = fct_ale_step
            self._tracer_step_fn = None
        else:
            self._step_fn = functools.partial(
                fct_ale_step_cuda, fuse_k12=fuse_k12, fuse_k34=fuse_k34)
            self._tracer_step_fn = functools.partial(
                fct_ale_step_cuda_batched, fuse_k12=fuse_k12,
                fuse_k34=fuse_k34)
        self.mesh = mesh
        self.cfg = cfg
        self.backend = backend
        self.fuse_k12 = fuse_k12
        self.fuse_k34 = fuse_k34
        self.device = device
        self.md = build_mesh_data(mesh, cfg.dtype, device)
        if backend == "cuda" and fuse_k34:
            check_edge_order(self.md.edges)  # H-K34's edge ranges

    def init_state(self, fields: dict) -> dict:
        """Host numpy fields -> tensors of the config dtype on the device
        (copies: the state never aliases the caller's arrays)."""
        return {
            k: torch.tensor(np.asarray(v), dtype=self.cfg.dtype,
                            device=self.device)
            for k, v in fields.items()
        }

    def step(self, state: dict) -> dict:
        return self._step_fn(self.md, self.cfg, state)

    def run(self, state: dict, n_steps: int) -> dict:
        """n_steps of the step function; the carry keeps the input's keys
        and drops the diagnostic ones, as the JAX solver's scan does."""
        for _ in range(n_steps):
            new = self._step_fn(self.md, self.cfg, state)
            state = {k: new[k] for k in state}
        return state

    # ---- multi-tracer batching (backend="cuda") -------------------------

    def init_state_tracers(self, fields: dict) -> dict:
        """Host numpy multi-tracer fields -> tensors on the device, as
        :meth:`init_state`: each per-tracer field [Tb, L, N] (or [Tb, L+1,
        N], [Tb, L, Ed]), ``hnode`` and ``hnode_new`` shared [L, N]."""
        return self.init_state(fields)

    def _tracer_step(self):
        if self._tracer_step_fn is None:
            raise ValueError("tracer batching runs the CUDA kernels: "
                             "backend='cuda', as the JAX package batches "
                             "on backend='pallas' only")
        return self._tracer_step_fn

    def step_tracers(self, state: dict) -> dict:
        """One step of every tracer of a multi-tracer state (per-tracer
        fields [Tb, ...], ``hnode``/``hnode_new`` shared): Tb independent
        :meth:`step` results, each per-tracer output [Tb, ...], in the
        launches of one step."""
        return self._tracer_step()(self.md, self.cfg, state)

    def run_tracers(self, state: dict, n_steps: int) -> dict:
        """n_steps of :meth:`step_tracers`; the carry keeps the input's
        keys, as :meth:`run`'s does."""
        step = self._tracer_step()
        for _ in range(n_steps):
            new = step(self.md, self.cfg, state)
            state = {k: new[k] for k in state}
        return state
