"""Single-device FCT-ALE solver (PyTorch port).

Counterpart of ``fesom2_accelerate_tpu/model/fct_ale.py``.  The phase split
of the reference (src/fesom2-accelerate.cu:258-379) survives as
``pre_comm`` / ``inter_comm`` / ``post_comm``, the places where a sharded
run inserts its halo exchange (docs/refactoring.md:200,235).  The solver's
methods of those names run one part's step around an exchange that its
caller makes (a FESOM2 rank's own ``exchange_nod``, through
``host_embed``), on either backend: the plain stages (:data:`PHASES`
"torch", as ``parallel/step_sharded.py``'s plain step runs them) or the
split step's K1, K2 | K3 | K4-fix (``ops/cuda/step.py``).  The solver
keeps the mesh tensors on one explicit device and runs one of two step
functions over state tensors on that device:

* ``backend="cuda"``: :func:`~fesom2_accelerate_tpu_torch.ops.cuda.step.
  fct_ale_step_cuda`, hand-written CUDA kernels; CUDA devices only.  The
  keywords ``fuse_k12`` and ``fuse_k34`` choose its form (K12 or K1 -> K2,
  K34 or K3 -> K4), the counterparts of the JAX package's
  ``build_pallas_data(fuse_k12=, fuse_k34=)``; by default K12 -> K3 -> K4
  (``ops/cuda/step.py`` ``DEFAULT_FORM``), the fastest form measured on
  whole meshes;
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

``run`` and ``run_tracers`` on ``backend="cuda"`` replay the steps as CUDA
graphs (:mod:`~fesom2_accelerate_tpu_torch.runtime.graphs`), the
counterpart of the JAX solver's ``jit(lax.scan)``: one enqueue for a block
of steps, results bit-identical to the loop of ``step``.  They do so where
the host's enqueue, not the card, sets the pace of a step (timed once per
state signature, ``graphs.StepGraphs.run``); where the card does, as on
core2, the graphs' copies would cost more than they save and the run is
the loop of steps.  ``step`` and ``step_tracers`` run one step eagerly,
each the span ``solver.step`` under a profiler (``runtime/tracing.py``).
On the card a step is enqueued from a launch plan (``ops/cuda/step.py``
``StepPlans``): built at the first step of a state signature, it holds the
kernels' launchers with their arguments bound, so a step checks each state
tensor once and allocates and launches each kernel in turn.  A run of 0 or 1
steps is the loop of steps, with no graph bookkeeping.
``backend="torch"`` (the plain stages, the correctness gate, on any
device) runs the Python loop of steps.
"""

from __future__ import annotations

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig, resolve_backend
from fesom2_accelerate_tpu_torch.mesh.topology import Mesh
from fesom2_accelerate_tpu_torch.ops import stages
from fesom2_accelerate_tpu_torch.ops.cuda import step as cstep
from fesom2_accelerate_tpu_torch.ops.meshdata import (
    MeshData,
    build_mesh_data,
    check_edge_order,
)
from fesom2_accelerate_tpu_torch.runtime import graphs, tracing


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


def pre_exchange(md: MeshData, cfg: FctAleConfig, state: dict) -> dict:
    """:func:`pre_comm` on a state, its limiter factors ``fct_plus`` and
    ``fct_minus`` stacked into the two halves of one [2, ...] tensor, so
    that ``kernels.factor_pair`` gives both as one view, as the CUDA
    phase ``ops/cuda/step.py:pre_exchange`` does: halo columns written
    into the pair are what the halves read."""
    lim = pre_comm(md, cfg, state["ttf"], state["fct_LO"],
                   state["fct_adf_v"], state["fct_adf_h"])
    both = torch.stack([lim["fct_plus"], lim["fct_minus"]])
    lim.update(fct_plus=both[0], fct_minus=both[1])
    return lim


def limit_vertical(md: MeshData, cfg: FctAleConfig, state: dict,
                   lim: dict) -> tuple:
    """:func:`inter_comm` on :func:`pre_exchange`'s factors: node-local
    work that reads no exchanged value."""
    return inter_comm(md, cfg, lim["fct_plus"], lim["fct_minus"],
                      state["fct_adf_v"])


def post_exchange(md: MeshData, cfg: FctAleConfig, state: dict, lim: dict,
                  vert: tuple, owned: tuple | None = None) -> dict:
    """:func:`post_comm` on the (exchanged) factors of ``lim`` and stage c
    -> the step's output dict.  ``owned`` is not read: b3 horizontal
    limits every edge on the exchanged factors."""
    return update_step(md, cfg, state, lim, vert,
                       post_comm(md, cfg, lim["fct_plus"], lim["fct_minus"],
                                 state["fct_adf_h"]))


# a part's step in three phases around the exchange of its limiter factors,
# by backend: before it (the factors), while it is in flight (what reads no
# exchanged value), after it (on the owned columns (lo, hi))
PHASES = {
    "torch": (pre_exchange, limit_vertical, post_exchange),
    "cuda": (cstep.pre_exchange, cstep.limit_edges, cstep.post_exchange_split),
}


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
        state = solver.run(state, n_steps=10)  # CUDA graphs where they pay
        # a part's step around a host's exchange of fct_plus / fct_minus
        pre = solver.pre_comm(state)
        inter = solver.inter_comm(state, pre)
        ...  # the halo columns of factor_pair(pre["fct_plus"], ...) filled
        state = solver.post_comm(state, pre, inter, owned=(0, n_owned))
        # Tb tracers: per-tracer fields [Tb, ...], hnode/hnode_new [L, N]
        batch = solver.run_tracers(solver.init_state_tracers(fields_tb), 10)

    backend: None (the default: "cuda" on a CUDA ``device``, "torch" on
    the CPU), "torch" (plain PyTorch stages, any device and float dtype)
    or "cuda" (the CUDA kernels; ``device`` must be a CUDA device).  With
    "cuda" the step and the tracer step run K12 -> K3 -> K4 by default
    (``cstep.DEFAULT_FORM``); ``fuse_k12=False`` runs K1 -> K2 in place of
    K12 and ``fuse_k34=True`` runs K34 in place of K3 -> K4; "torch"
    refuses any value but the default.  A CUDA solver whose form runs K34
    needs the mesh's edges sorted by first endpoint (``MeshData.ed_ptr``)
    and raises at construction otherwise.  The tracer methods need
    "cuda"."""

    def __init__(self, mesh: Mesh, cfg: FctAleConfig = FctAleConfig(),
                 backend: str | None = None, *,
                 device: torch.device | str,
                 fuse_k12: bool = cstep.DEFAULT_FORM[0],
                 fuse_k34: bool = cstep.DEFAULT_FORM[1]):
        device = torch.device(device)
        backend = resolve_backend(backend, device)
        if backend == "torch":
            if (fuse_k12, fuse_k34) != cstep.DEFAULT_FORM:
                raise ValueError(
                    "fuse_k12 and fuse_k34 choose the form of "
                    "backend='cuda'; backend='torch' takes the defaults")
            self._step_fn = fct_ale_step
            self._tracer_step_fn = None
        else:
            self._step_fn = cstep.StepPlans(fuse_k12=fuse_k12,
                                            fuse_k34=fuse_k34)
            self._tracer_step_fn = cstep.StepPlans(
                fuse_k12=fuse_k12, fuse_k34=fuse_k34, batched=True)
        self._phases = PHASES[backend]
        self.mesh = mesh
        self.cfg = cfg
        self.backend = backend
        self.fuse_k12 = fuse_k12
        self.fuse_k34 = fuse_k34
        self.device = device
        self.md = build_mesh_data(mesh, cfg.dtype, device)
        if backend == "cuda" and fuse_k34:
            check_edge_order(self.md.edges)  # H-K34's edge ranges
        self._graphs = (graphs.StepGraphs(device) if backend == "cuda"
                        else None)

    def init_state(self, fields: dict) -> dict:
        """Host numpy fields -> tensors of the config dtype on the device
        (copies: the state never aliases the caller's arrays)."""
        return {
            k: torch.tensor(np.asarray(v), dtype=self.cfg.dtype,
                            device=self.device)
            for k, v in fields.items()
        }

    @tracing.spanned("solver.step")
    def step(self, state: dict) -> dict:
        return self._step_fn(self.md, self.cfg, state)

    # ---- a part's step around a host's exchange -------------------------

    @tracing.spanned("solver.pre_comm")
    def pre_comm(self, state: dict) -> dict:
        """A part's step up to the exchange of its limiter factors (the
        reference's ``fct_ale_pre_comm_acc_``): K1, K2 on backend "cuda"
        (whatever the form flags), the plain stages a1..b2 on "torch" -> a
        dict whose ``fct_plus`` and ``fct_minus`` are the two halves of one
        [2, ...] tensor (``kernels.factor_pair``): the exchange writes their
        halo columns there."""
        return self._phases[0](self.md, self.cfg, state)

    @tracing.spanned("solver.inter_comm")
    def inter_comm(self, state: dict, pre: dict):
        """The work that reads no exchanged value, enqueued while the
        exchange is in flight (``fct_ale_inter_comm_acc_``): K3, every edge
        limited on the factors of ``pre`` as they are ("cuda"), or b3
        vertical ("torch")."""
        return self._phases[1](self.md, self.cfg, state, pre)

    @tracing.spanned("solver.post_comm")
    def post_comm(self, state: dict, pre: dict, inter,
                  owned: tuple) -> dict:
        """The rest of the step, on the exchanged factors of ``pre``
        (``fct_ale_post_comm_acc_``) -> the output dict of :meth:`step`:
        K4-fix ("cuda": the edges with an endpoint outside the owned
        columns ``owned = (lo, hi)`` limited again, and stage c, in one
        launch), or b3 horizontal and stage c ("torch").  With every column
        owned and no halo, the three phases give the bits of :meth:`step`
        (on the card, K3 then K4-fix give those of K34)."""
        return self._phases[2](self.md, self.cfg, state, pre, inter, owned)

    def run(self, state: dict, n_steps: int) -> dict:
        """n_steps of the step function; the carry keeps the input's keys
        and drops the diagnostic ones, as the JAX solver's scan does.  On
        backend "cuda" the steps replay as CUDA graphs where the host sets
        the pace (cached per block length, as the JAX solver caches its
        scan per n_steps), else the loop; backend "torch" runs the Python
        loop of :meth:`step`.  Either way the fields a step changes are
        new tensors and the others are ``state``'s own."""
        return self._run(self.step, state, n_steps)

    def _run(self, step, state: dict, n_steps: int) -> dict:
        if self._graphs is None:
            return graphs.loop(step, state, n_steps)
        return self._graphs.run(step, state, n_steps)

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

    @tracing.spanned("solver.step")
    def step_tracers(self, state: dict) -> dict:
        """One step of every tracer of a multi-tracer state (per-tracer
        fields [Tb, ...], ``hnode``/``hnode_new`` shared): Tb independent
        :meth:`step` results, each per-tracer output [Tb, ...], in the
        launches of one step."""
        return self._tracer_step()(self.md, self.cfg, state)

    def run_tracers(self, state: dict, n_steps: int) -> dict:
        """n_steps of :meth:`step_tracers`, as :meth:`run` runs those of
        :meth:`step`."""
        self._tracer_step()  # raises on backend "torch", even for 0 steps
        return self._run(self.step_tracers, state, n_steps)
