"""The FCT-ALE step as CUDA kernels, whole or in the phases of a sharded step.

Counterpart of ``fesom2_accelerate_tpu/ops/pallas/step.py``
(``fct_ale_step_pallas_padded`` and ``_assemble_step_out``).  The kernels
take natural shapes ([L, N] node fields, [L+1, N] interface fields, [L, Ed]
edge fields), so there is no padding, packing or tiling step around them:
the Pallas planners (``plan.py``, ``packed.py``) are TPU layout machinery.
On CPU tensors each kernel wrapper runs its plain PyTorch version.

A sharded step fills the halo columns of ``fct_plus``/``fct_minus`` between
K2 and the b3 horizontal limiting, both in one exchange of the pair
(``kernels.factor_pair``, the JAX sharded step's ``jnp.stack([plus,
minus])``).  The
phases around that exchange:

* :func:`pre_exchange`: K1 bounds, K2 limit (the limiter factors), or
  K12 (both in one kernel; a sharded step runs K1, K2);
* :func:`limit_edges`: split mode's K3, every edge limited on the
  pre-exchange factors (edges with no halo endpoint are then final); it
  reads no halo column's exchanged value, so the exchange is in flight
  while it runs;
* :func:`post_exchange_fused`: K34, from the exchanged factors;
* :func:`post_exchange_split`: K4-fix, one launch (``kernels.update_fixup``,
  K4 in its FIX form): the edges that touch a halo node limited again from
  the exchanged factors, in place into K3's outputs, and stage c.  K3fix
  then K4 (``kernels.b3h_fixup``, ``kernels.update``) computes the same
  bits in two launches; the step no longer runs them.

A step over P parts in one process enqueues every part's pre-exchange
phase, starts the one exchange, enqueues every part's K3 (split mode),
then finishes the exchange, so the exchange is not called from inside a
part's step (``parallel/step_sharded.py``).  The iterative mode's
``fct_LO`` halo refresh after stage c is done there as well.  One part
whose exchange its host makes (a FESOM2 rank through ``host_embed``'s
``pre_comm`` / ``post_comm``) runs :func:`pre_exchange`,
:func:`limit_edges` and :func:`post_exchange_split` as
``FctAleSolver.pre_comm`` / ``inter_comm`` / ``post_comm``.
:func:`fct_ale_step_cuda` is the single-device step, in one of the four
forms the JAX package selects with ``build_pallas_data(fuse_k12=,
fuse_k34=)``: K1 -> K2 or K12, then K34 or K3 -> K4.  On one device there
is no halo, so K3 needs no fixup.  The default is K12 -> K3 -> K4
(:data:`DEFAULT_FORM`), at every tracer count.  Every phase takes
``threads``, the kernels' block size.

Every phase also takes a batched state, the layout of the JAX package's
``fct_ale_step_pallas_batched``: each per-tracer field with a leading
tracer axis ([Tb, L, N], [Tb, L+1, N], [Tb, L, Ed]) and ``hnode``,
``hnode_new`` (``BATCH_SHARED``) shared [L, N].  The kernels take the
tracer axis in one launch each, so a batched step launches what a
single-tracer step does, whatever Tb is; :func:`fct_ale_step_cuda_batched`
is that step, in any of the four forms.
"""

from __future__ import annotations

import math

import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.cuda.kernels import DEFAULT_THREADS
from fesom2_accelerate_tpu_torch.ops.meshdata import MeshData
from fesom2_accelerate_tpu_torch.runtime import tracing

# the fields of a batched state that every tracer shares ([L, N], no axis)
BATCH_SHARED = frozenset({"hnode", "hnode_new"})

# (fuse_k12, fuse_k34) of the single-device step where its caller names
# neither: K12 -> K3 -> K4.  On core2 and the core2-size RCM cylinder,
# where two thirds of the edges cross a node tile of 32 and H-K34 limits
# each of those twice, it beat K1 -> K2 -> K34 at one and two tracers, in
# float32 and float64, by 4-13% of the kernels' time (PERF.md §6):
# H-K12 keeps the bounds out of device memory, and H-K3's one pass over
# the edges and H-K4's slot sum cost less than H-K34's second limiting of
# the crossing edges.  No mesh measured preferred another form, so the
# plan reads no property of the mesh to choose it.
DEFAULT_FORM = (True, False)

# the state fields that every form of the whole step reads, in the order in
# which its kernel wrappers check them; K1 reads the first two, K12 the
# first four
STEP_INPUTS = ("fct_LO", "ttf", "fct_adf_v", "fct_adf_h", "hnode",
               "hnode_new", "del_ttf_advvert", "del_ttf_advhoriz")


def pre_exchange(md: MeshData, cfg: FctAleConfig, state: dict, *,
                 fuse_k12: bool = False,
                 threads: int = DEFAULT_THREADS) -> dict:
    """K1, K2 (or K12 when ``fuse_k12``) -> the bounds, the limiter factors
    and the limited vertical fluxes (``adf_v_res`` is None unless
    ``iter_yn``).  ``fct_plus`` and ``fct_minus`` are the two halves of
    one [2, ...] allocation (the kernels' own on the card; stacked once
    from the plain versions' on the CPU), so that
    ``kernels.factor_pair(pre["fct_plus"], pre["fct_minus"])`` is both as
    one tensor without a copy, and one halo fill of it exchanges both."""
    if fuse_k12:
        tmax, tmin, plus, minus, adf_v_lim, adf_v_res = kernels.limit_fused(
            md, state["fct_LO"], state["ttf"], state["fct_adf_v"],
            state["fct_adf_h"], cfg.vlimit, cfg.dt, cfg.flux_eps,
            cfg.iter_yn, threads=threads)
    else:
        tmax, tmin = kernels.bounds(md, state["fct_LO"], state["ttf"],
                                    cfg.vlimit, threads=threads)
        plus, minus, adf_v_lim, adf_v_res = kernels.limit(
            md, state["fct_adf_v"], tmax, tmin, state["fct_adf_h"], cfg.dt,
            cfg.flux_eps, cfg.iter_yn, threads=threads)
    plus, minus = kernels.factor_pair(plus, minus)
    return dict(fct_ttf_max=tmax, fct_ttf_min=tmin, fct_plus=plus,
                fct_minus=minus, adf_v_lim=adf_v_lim, adf_v_res=adf_v_res)


def limit_edges(md: MeshData, cfg: FctAleConfig, state: dict, pre: dict,
                *, threads: int = DEFAULT_THREADS) -> tuple:
    """K3 on the factors of ``pre`` -> (limited fct_adf_h, residual)."""
    return kernels.b3h(md, pre["fct_plus"], pre["fct_minus"],
                       state["fct_adf_h"], cfg.iter_yn, threads=threads)


def post_exchange_fused(md: MeshData, cfg: FctAleConfig, state: dict,
                        pre: dict, *,
                        threads: int = DEFAULT_THREADS) -> dict:
    """K34 on the factors of ``pre`` -> the step's output dict."""
    o1, o2, adf_h_lim, adf_h_res = kernels.update_fused(
        md, pre["fct_plus"], pre["fct_minus"], pre["adf_v_lim"],
        state["fct_adf_h"], state["ttf"], state["hnode"],
        state["hnode_new"], state["fct_LO"], state["del_ttf_advvert"],
        state["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn, threads=threads)
    return _assemble(cfg, state, pre, o1, o2, adf_h_lim, adf_h_res)


def post_exchange_split(md: MeshData, cfg: FctAleConfig, state: dict,
                        pre: dict, edges: tuple, owned: tuple, *,
                        threads: int = DEFAULT_THREADS) -> dict:
    """K4-fix -> the step's output dict: the edges of the part with an
    endpoint outside its owned columns ``owned = (lo, hi)`` limited again
    with the (exchanged) factors of ``pre``, in place into ``edges`` (K3's
    output), and stage c, in one launch."""
    o1, o2, adf_h_lim, adf_h_res = kernels.update_fixup(
        md, pre["fct_plus"], pre["fct_minus"], state["fct_adf_h"], *edges,
        owned, pre["adf_v_lim"], state["ttf"], state["hnode"],
        state["hnode_new"], state["fct_LO"], state["del_ttf_advvert"],
        state["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn, threads=threads)
    return _assemble(cfg, state, pre, o1, o2, adf_h_lim, adf_h_res)


def _update(md: MeshData, cfg: FctAleConfig, state: dict, pre: dict,
            edges: tuple, threads: int) -> dict:
    """K4 on the limited fluxes of ``pre`` and ``edges`` -> the step's
    output dict."""
    adf_h_lim, adf_h_res = edges
    o1, o2 = kernels.update(
        md, pre["adf_v_lim"], adf_h_lim, state["ttf"], state["hnode"],
        state["hnode_new"], state["fct_LO"], state["del_ttf_advvert"],
        state["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn, threads=threads)
    return _assemble(cfg, state, pre, o1, o2, adf_h_lim, adf_h_res)


def _assemble(cfg: FctAleConfig, state: dict, pre: dict, o1, o2, adf_h_lim,
              adf_h_res) -> dict:
    """The output dict of every form of the step: the keys of
    ``model.fct_ale.fct_ale_step`` for both ``iter_yn`` values."""
    out = dict(state)
    out.update(fct_ttf_max=pre["fct_ttf_max"], fct_ttf_min=pre["fct_ttf_min"],
               fct_plus=pre["fct_plus"], fct_minus=pre["fct_minus"])
    if cfg.iter_yn:
        out.update(
            fct_LO=o1,
            fct_adf_v=pre["adf_v_res"],
            fct_adf_h=adf_h_res,
            fct_adf_v_limited=pre["adf_v_lim"],
            fct_adf_h_limited=adf_h_lim,
        )
    else:
        out.update(
            fct_adf_v=pre["adf_v_lim"],
            fct_adf_h=adf_h_lim,
            del_ttf_advvert=o1,
            del_ttf_advhoriz=o2,
        )
    return out


def fct_ale_step_cuda(md: MeshData, cfg: FctAleConfig, state: dict, *,
                      fuse_k12: bool = DEFAULT_FORM[0],
                      fuse_k34: bool = DEFAULT_FORM[1],
                      threads: int = DEFAULT_THREADS) -> dict:
    """Same contract as ``model.fct_ale.fct_ale_step``: the output dict has
    the same keys, for both ``iter_yn`` values.  Launches per step: K12 ->
    K34 2, K1 -> K2 -> K34 and K12 -> K3 -> K4 3, K1 -> K2 -> K3 -> K4 4."""
    pre = pre_exchange(md, cfg, state, fuse_k12=fuse_k12, threads=threads)
    if fuse_k34:
        return post_exchange_fused(md, cfg, state, pre, threads=threads)
    edges = limit_edges(md, cfg, state, pre, threads=threads)
    return _update(md, cfg, state, pre, edges, threads)


def fct_ale_step_cuda_batched(md: MeshData, cfg: FctAleConfig, state: dict,
                              *, fuse_k12: bool = DEFAULT_FORM[0],
                              fuse_k34: bool = DEFAULT_FORM[1],
                              threads: int = DEFAULT_THREADS) -> dict:
    """The multi-tracer step, counterpart of the JAX package's
    ``fct_ale_step_pallas_batched``: ``state`` holds each per-tracer field
    [Tb, ...] and ``hnode``/``hnode_new`` shared [L, N]; the output has the
    keys of :func:`fct_ale_step_cuda`, each per-tracer one [Tb, ...].  Tb
    independent single-tracer steps, in the launches of one, in the form
    the flags choose (the JAX package's batched step runs K1 -> K2 ->
    K34 only)."""
    _check_batched(state)
    return fct_ale_step_cuda(md, cfg, state, fuse_k12=fuse_k12,
                             fuse_k34=fuse_k34, threads=threads)


def _check_batched(state: dict) -> None:
    if state["ttf"].dim() != 3:
        raise ValueError(f"a batched state holds ttf as [Tb, L, N], got "
                         f"shape {tuple(state['ttf'].shape)}")


# --------------------------------------------------------------------------
# The whole step enqueued from a launch plan
# --------------------------------------------------------------------------


def input_shapes(md: MeshData, tb: int | None) -> dict:
    """The shape of each of STEP_INPUTS in a state of ``tb`` tracers (None:
    one tracer, no axis)."""
    L, N, Ed = md.n_layers, md.n_nodes, md.n_edges
    rows = kernels._rows
    return dict(fct_LO=rows(tb, L, N), ttf=rows(tb, L, N),
                fct_adf_v=rows(tb, L + 1, N), fct_adf_h=rows(tb, L, Ed),
                hnode=(L, N), hnode_new=(L, N),
                del_ttf_advvert=rows(tb, L, N),
                del_ttf_advhoriz=rows(tb, L, N))


def check_state(md: MeshData, state: dict, *,
                threads: int = DEFAULT_THREADS) -> int | None:
    """Tb of ``state`` (None: no tracer axis), after the checks that the
    whole step's kernel wrappers make of it, with their errors: the block
    size, the tracer axis, the incidence slots, then the device, dtype,
    shape and contiguity of each of STEP_INPUTS against the mesh data's
    (``kernels.check_tensors``: tensor metadata only, so CPU mesh data and
    tensors take the same checks)."""
    slots = md.nd_idx.shape[1]
    kernels.check_threads(threads, slots)
    tb = kernels._tracers(state["fct_LO"])
    kernels.check_slots(slots)
    kernels.check_tensors(
        {k: (state[k], shape) for k, shape in input_shapes(md, tb).items()},
        md.device, md.dtype)
    return tb


class StepPlan:
    """One form of the whole step for one mesh data, configuration and
    state signature (Tb; every input's shape, dtype and device follow from
    the mesh data): each kernel's launcher with its mesh-data pointers and
    static scalars bound (``kernels.<kernel>_launch``, the wrappers' own),
    and the shapes of the inputs and outputs.

    ``plan(state)`` enqueues the step that :func:`fct_ale_step_cuda` does,
    from the same launchers with the same arguments: the same kernels, in
    the same order, on the current stream, so the same bits.  The first
    kernel's inputs (:attr:`first`) must have passed :meth:`fits`; the
    others are checked once, after its launch, and a call whose fields do
    not fit raises the wrappers' errors (:func:`check_state`).  Each kernel
    is its wrapper's span and adds one to its wrapper's ``launches``; its
    outputs are allocated just before its launch and not checked again.
    Output pairs that a step always returns together are the two halves of
    one allocation: fct_ttf_max and fct_ttf_min, the limiter factors (as
    the wrappers' ``kernels.factor_pair``), the two increments of a
    non-iterative step; K12's two pairs are the halves of one allocation,
    so that one allocation fewer comes before the step's first launch.
    Every call returns new output tensors."""

    def __init__(self, md: MeshData, cfg: FctAleConfig, tb: int | None, *,
                 fuse_k12: bool = DEFAULT_FORM[0],
                 fuse_k34: bool = DEFAULT_FORM[1],
                 threads: int = DEFAULT_THREADS):
        self.md, self.cfg, self.tb = md, cfg, tb
        self.fuse_k12, self.fuse_k34, self.threads = (fuse_k12, fuse_k34,
                                                      threads)
        self.device, self.dtype = md.device, md.dtype
        fields = tuple((k, torch.Size(shape))
                       for k, shape in input_shapes(md, tb).items())
        self.first = fields[:4 if fuse_k12 else 2]
        self.rest = fields[len(self.first):]
        L, N, Ed = md.n_layers, md.n_nodes, md.n_edges
        nodes = kernels._rows(tb, L, N)
        # the outputs' shapes as one element expanded: torch.empty_like of
        # one allocates a contiguous tensor of its shape, dtype and device
        # in less of the host's time than torch.empty given them
        blank = torch.empty(1, dtype=self.dtype, device=self.device)
        self.nodes, self.pair = blank.expand(nodes), blank.expand(2, *nodes)
        self.quad = blank.expand(2, 2, *nodes)
        self.levels = blank.expand(kernels._rows(tb, L + 1, N))
        self.edges = blank.expand(kernels._rows(tb, L, Ed))
        # the offset of a pair's second half
        self.half = math.prod(nodes) * self.dtype.itemsize
        k = tb or 1
        if fuse_k12:
            self.k12 = kernels.limit_fused_launch(md, cfg.vlimit, cfg.dt,
                                                  cfg.flux_eps, k, threads)
        else:
            self.k1 = kernels.bounds_launch(md, cfg.vlimit, k, threads)
            self.k2 = kernels.limit_launch(md, cfg.dt, cfg.flux_eps, k,
                                           threads)
        if fuse_k34:
            self.k34 = kernels.update_fused_launch(md, cfg.dt, cfg.iter_yn, k,
                                                   threads)
        else:
            self.k3 = kernels.b3h_launch(md, k, threads)
            self.k4 = kernels.update_launch(md, cfg.dt, cfg.iter_yn, k,
                                            threads)

    def fits(self, state: dict, fields) -> bool:
        """Whether the tensors of ``state`` named in ``fields`` (pairs of a
        name and its shape, :attr:`first` or :attr:`rest`) are contiguous,
        of the plan's shapes, dtype and device."""
        dtype, device = self.dtype, self.device
        for k, shape in fields:
            t = state[k]
            if (t.shape != shape or t.dtype != dtype or t.device != device
                    or not t.is_contiguous()):
                return False
        return True

    def __call__(self, state: dict) -> dict:
        tracing.count("solver.plan_steps")
        if self.fuse_k12:
            tracing.count("solver.k12_steps")
        with kernels.selected(self.device):
            return self._enqueue(state, kernels.current_stream(self.device))

    def _check_rest(self, state: dict) -> None:
        if not self.fits(state, self.rest):
            check_state(self.md, state, threads=self.threads)
            raise ValueError("the state does not fit its launch plan")

    def _enqueue(self, state: dict, stream: int) -> dict:
        iter_yn, half, empty, ptr = (self.cfg.iter_yn, self.half,
                                     torch.empty_like, kernels._ptr)
        lo, ttf = state["fct_LO"].data_ptr(), state["ttf"].data_ptr()
        if self.fuse_k12:
            v, h = state["fct_adf_v"].data_ptr(), state["fct_adf_h"].data_ptr()
            with tracing.span("kernels.limit_fused"):
                quad = empty(self.quad)
                v_lim = empty(self.levels)
                v_res = empty(self.levels) if iter_yn else None
                b = quad.data_ptr()
                f = b + 2 * half
                kernels.check_launch("fct_limit_fused", self.k12(
                    lo, ttf, v, h, b, b + half, f, f + half, v_lim.data_ptr(),
                    ptr(v_res), stream))
            kernels.limit_fused.launches += 1
            bounds, factors = quad.unbind()
            self._check_rest(state)
        else:
            with tracing.span("kernels.bounds"):
                bounds = empty(self.pair)
                b = bounds.data_ptr()
                kernels.check_launch("fct_bounds",
                                     self.k1(lo, ttf, b, b + half, stream))
            kernels.bounds.launches += 1
            self._check_rest(state)
            h = state["fct_adf_h"].data_ptr()
            with tracing.span("kernels.limit"):
                factors = empty(self.pair)
                v_lim = empty(self.levels)
                v_res = empty(self.levels) if iter_yn else None
                f = factors.data_ptr()
                kernels.check_launch("fct_limit", self.k2(
                    state["fct_adf_v"].data_ptr(), b, b + half, h, f,
                    f + half, v_lim.data_ptr(), ptr(v_res), stream))
            kernels.limit.launches += 1
        # stage c's node inputs, in the launchers' order
        c = (ttf, state["hnode"].data_ptr(),
             state["hnode_new"].data_ptr(), lo,
             state["del_ttf_advvert"].data_ptr(),
             state["del_ttf_advhoriz"].data_ptr())
        if self.fuse_k34:
            with tracing.span("kernels.update_fused"):
                o = empty(self.nodes if iter_yn else self.pair)
                h_lim = empty(self.edges)
                h_res = empty(self.edges) if iter_yn else None
                p = o.data_ptr()
                kernels.check_launch("fct_update_fused", self.k34(
                    f, f + half, v_lim.data_ptr(), h, *c, p,
                    None if iter_yn else p + half, h_lim.data_ptr(),
                    ptr(h_res), stream))
            kernels.update_fused.launches += 1
        else:
            with tracing.span("kernels.b3h"):
                h_lim = empty(self.edges)
                h_res = empty(self.edges) if iter_yn else None
                kernels.check_launch("fct_b3h", self.k3(
                    f, f + half, h, h_lim.data_ptr(), ptr(h_res), stream))
            kernels.b3h.launches += 1
            with tracing.span("kernels.update"):
                o = empty(self.nodes if iter_yn else self.pair)
                p = o.data_ptr()
                kernels.check_launch("fct_update", self.k4(
                    v_lim.data_ptr(), h_lim.data_ptr(), *c, p,
                    None if iter_yn else p + half, stream))
            kernels.update.launches += 1
        tmax, tmin = bounds.unbind()
        plus, minus = factors.unbind()
        o1, o2 = (o, None) if iter_yn else o.unbind()
        pre = dict(fct_ttf_max=tmax, fct_ttf_min=tmin, fct_plus=plus,
                   fct_minus=minus, adf_v_lim=v_lim, adf_v_res=v_res)
        return _assemble(self.cfg, state, pre, o1, o2, h_lim, h_res)


class StepPlans:
    """A step function of one form, :func:`fct_ale_step_cuda` (or, with
    ``batched``, :func:`fct_ale_step_cuda_batched`), whose steps on the
    card are enqueued from launch plans: ``plans(md, cfg, state)`` has
    their contract and results.  A :class:`StepPlan` is built at the first
    call of each mesh data, configuration and state signature, and kept;
    a call checks the state's tensors once against the plan it last used,
    and looks the plan up anew only where they do not fit it.  Mesh data on
    the CPU runs the wrappers' plain versions (:func:`fct_ale_step_cuda`),
    from no plan.  Counters (``runtime/tracing.py``): ``solver.plans_built``,
    ``solver.plan_steps`` (steps enqueued from a plan) and
    ``solver.k12_steps`` (those of them that launched H-K12)."""

    def __init__(self, *, fuse_k12: bool = DEFAULT_FORM[0],
                 fuse_k34: bool = DEFAULT_FORM[1], batched: bool = False,
                 threads: int = DEFAULT_THREADS):
        self.fuse_k12, self.fuse_k34 = fuse_k12, fuse_k34
        self.batched, self.threads = batched, threads
        # (id of the mesh data, config, Tb) -> plan; each plan holds its
        # mesh data, so no id is reused while its plan is kept
        self._plans = {}
        self._last = None

    def __call__(self, md: MeshData, cfg: FctAleConfig, state: dict) -> dict:
        if self.batched:
            _check_batched(state)
        plan = self._last
        if (plan is None or plan.md is not md or plan.cfg is not cfg
                or not plan.fits(state, plan.first)):
            if md.device.type != "cuda":
                return fct_ale_step_cuda(md, cfg, state,
                                         fuse_k12=self.fuse_k12,
                                         fuse_k34=self.fuse_k34,
                                         threads=self.threads)
            plan = self._last = self.plan(md, cfg, state)
        return plan(state)

    def plan(self, md: MeshData, cfg: FctAleConfig, state: dict) -> StepPlan:
        """The plan of ``state``'s signature, built at its first call;
        raises as :func:`check_state` where the state does not fit the mesh
        data."""
        tb = check_state(md, state, threads=self.threads)
        key = (id(md), cfg, tb)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = StepPlan(
                md, cfg, tb, fuse_k12=self.fuse_k12, fuse_k34=self.fuse_k34,
                threads=self.threads)
            tracing.count("solver.plans_built")
        return plan
