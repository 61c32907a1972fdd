"""Bytes-moved models (numpy), for rates printed beside measured times.

A copy of the numpy byte models of
``fesom2_accelerate_tpu/runtime/profiling.py`` (``grid_points``,
``fct_ale_step_bytes``, ``stress2rhs_bytes``): the port cannot import the
JAX package, whose ``__init__`` imports jax.  The code is kept identical,
so both packages count the same bytes for the same mesh.  The JAX module's
table of TPU memory peaks is not carried over: a peak beside a number of
the port is the card's own, measured or from its data sheet, and named
with the card.

Also here: a copy of the JAX tuning harness's per-family byte models
(:func:`kernel_bytes`, :func:`a2_bytes`), and the least work of each CUDA
kernel (:func:`kernel_io`: each input read once where the kernel's
function needs it, each output written once) with :func:`bound_ms`, which
turns it into a bound at a data-sheet peak (``PEAKS``); :func:`step_io`
sums it over the kernels of a step's form (``STEP_FORMS``).
:func:`measure_stream_bandwidth` measures the card's own memory roof, a
triad, the counterpart of the JAX module's function of that name.

The reference's perf methodology is explicit per-kernel bytes models
divided by measured time (kernels/fct_ale_a1.py:93-95 and friends).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.mesh.topology import Mesh
from fesom2_accelerate_tpu_torch.runtime.tracing import require_cuda


def fct_ale_step_bytes(mesh: Mesh, itemsize: int = 4,
                       iter_yn: bool = False) -> int:
    """Modeled memory traffic of one full a->b->c step, reference-style.

    Counts every array read/write once per stage at ``itemsize`` bytes per
    active entry (gathers counted once per incidence, like the reference's
    per-edge/per-cluster accounting in kernels/fct_ale_a3.py:116-151 and
    kernels/fct_ale_b1_horizontal.py:70-89).  Index/mask traffic (int32/bool)
    is included at 4/1 bytes.  Fused kernels can beat it only by keeping
    intermediates on chip.
    """
    L = mesh.n_layers
    nod = int(np.sum(mesh.nlev_nod - 1))  # active node-layers
    elem_active = int(np.sum(mesh.nlev_elem - 1))
    elem_full = L * mesh.n_elems  # a2 writes padded full depth
    edge = int(np.sum(mesh.nlev_edge))
    deg_e = int(np.sum(mesh.node_elems_num * (mesh.nlev_nod - 1)))
    deg_d = int(np.sum(mesh.node_edges_num * (mesh.nlev_nod - 1)))
    vint = int(np.sum(mesh.nlev_nod))  # interfaces incl. bottom
    f = itemsize

    b = 0
    # a1: read fct_LO, ttf; write tmax, tmin
    b += 4 * nod * f
    # a2: gather tmax,tmin at 3 nodes; write UV pair over full depth
    b += (2 * 3 * elem_active + 2 * elem_full) * f + 3 * 4 * mesh.n_elems
    # a3: gather UV pair over node's element cluster; read fct_LO;
    #     write tmax2, tmin2
    b += (2 * deg_e + 3 * nod) * f + 4 * deg_e // max(L - 1, 1)
    # b1v: read adf_v interfaces; write fct_plus/minus
    b += (vint + 2 * nod) * f
    # b1h: gather adf_h per node-edge incidence; read+write fct_plus/minus
    b += (deg_d + 4 * nod) * f + 4 * deg_d // max(L - 1, 1)
    # b2: read fct_plus/minus, tmax2, tmin2, area_inv; write fct_plus/minus
    b += 7 * nod * f
    # b3v: read fct_plus/minus, adf_v; write adf_v
    b += (2 * nod + 2 * vint) * f
    # b3h: gather fct_plus/minus at both edge ends; read+write adf_h
    b += (4 * edge + 2 * edge) * f + 2 * 4 * mesh.n_edges
    if iter_yn:
        # residual fluxes written in b3 + fct_LO update (read LO, hnode_new,
        # adf_v, gather adf_h; write LO)
        b += (vint + edge) * f
        b += (3 * nod + vint + deg_d + nod) * f
    else:
        # c: read ttf, hnode, LO, hnode_new, adf_v, del_v, del_h,
        #    gather adf_h; write del_v, del_h
        b += (7 * nod + vint + deg_d + 2 * nod) * f
    return b


def grid_points(mesh: Mesh) -> int:
    """Active node-layers per step — the throughput unit of the FCT step."""
    return int(np.sum(mesh.nlev_nod - 1))


def stress2rhs_bytes(mesh: Mesh, itemsize: int = 4) -> int:
    """Modeled memory traffic of one stress2rhs call (the second workload;
    reference src/reference.cpp:440-480), reference-style accounting:

    per element — 3 stress components, area+ice activity, metric factor,
    6 shape-function gradients read once (:445-462); the element->node
    scatter of the 2 (u, v) contributions at 3 corners counted once per
    incidence like the reference's per-edge models
    (kernels/fct_ale_b1_horizontal.py:70-89); per node — inv_areamass,
    rhs_a, rhs_m reads and the U/V writes (:464-476); int32 connectivity."""
    E, N = mesh.n_elems, mesh.n_nodes
    f = itemsize
    b = (3 + 1 + 1 + 6) * E * f  # element inputs
    b += 2 * 3 * E * f  # u/v contribution per corner incidence
    b += 5 * N * f  # inv_areamass, rhs_a, rhs_m reads; U, V writes
    b += 3 * 4 * E  # elem_nodes int32
    return b


# --------------------------------------------------------------------------
# The tuning harness's byte models
# --------------------------------------------------------------------------


def kernel_bytes(mesh: Mesh, itemsize: int = 4) -> dict:
    """Per-family reference-style bytes models of the tuning harness.

    ``bounds``, ``limit``, ``b3h`` and ``update`` are a copy of
    ``fesom2_accelerate_tpu/utils/tuning.py:_kernel_bytes`` (same terms,
    same values).  The two fused families are built from the same terms:
    ``limit_fused`` is ``bounds`` + ``limit`` less the re-read of the bounds
    (2 * nod); ``update_fused`` is ``b3h``'s factor gathers and flux write
    (5 * edge) plus ``update``, whose incidence term now reads the
    unlimited flux (K34 limits it in place of K3)."""
    nod = int(np.sum(mesh.nlev_nod - 1))
    edge = int(np.sum(mesh.nlev_edge))
    deg_d = int(np.sum(mesh.node_edges_num * (mesh.nlev_nod - 1)))
    vint = int(np.sum(mesh.nlev_nod))
    f = itemsize
    out = {
        # a1+a2+a3 fused: read lo/ttf, neighbor gather per incidence,
        # write tmax/tmin
        "bounds": (4 * nod + 2 * deg_d) * f,
        # b1v+b1h+b2+b3v: read adf_v, tt pair, area_inv, adf_h per
        # incidence; write pm pair, limited adf_v
        "limit": (2 * vint + 5 * nod + deg_d) * f,
        # b3h: gather pm at both ends, read + write adf_h
        "b3h": 6 * edge * f,
        # c: read 7 node fields + adf_v + adf_h per incidence; write 2
        "update": (9 * nod + vint + deg_d) * f,
    }
    out["limit_fused"] = out["bounds"] + out["limit"] - 2 * nod * f
    out["update_fused"] = 5 * edge * f + out["update"]
    return out


def a2_bytes(mesh: Mesh, itemsize: int = 4) -> int:
    """The standalone a2's bytes model, as ``tune_a2`` of the JAX harness
    computes it (``utils/tuning.py:308-309``): the 3-node gathers of both
    bounds on active element levels, the full-depth UV pair written."""
    elem_active = int(np.sum(mesh.nlev_elem - 1))
    return (6 * elem_active + 2 * mesh.n_layers * mesh.n_elems) * itemsize


# --------------------------------------------------------------------------
# The least work of each CUDA kernel, and its bound on a card
# --------------------------------------------------------------------------

# NVIDIA H100 SXM data sheet (dense rates, at the 700 W power limit): HBM3
# bandwidth and the peak rates outside the tensor cores
PEAKS = {
    "h100_sxm": {"bytes_per_s": 3.35e12, "float32": 67e12, "float64": 34e12},
}


def _gathered_levels(n_nodes: int, ends, depth) -> int:
    """Node-levels read through a gather: node n at levels z < the largest
    ``depth`` of the entries of ``ends`` (same shape) that name n."""
    top = torch.zeros(n_nodes, dtype=torch.int64, device=ends.device)
    top.scatter_reduce_(0, ends.reshape(-1).long(),
                        depth.reshape(-1).long().clamp(min=0), "amax")
    return int(top.sum())


def kernel_io(md, name: str, iter_yn: bool = False, *, ids=None,
              owned=None, slab=None, inv_areamass=None,
              tracers: int = 1) -> tuple[int, int]:
    """(bytes, operations) of one call of the CUDA kernel ``name`` (a
    wrapper of ``ops/cuda/kernels.py``) on mesh data ``md`` for ``tracers``
    tracers: what the kernel's function needs on this mesh and, where the
    work depends on the data, on these inputs.

    Bytes: each output written once at its full size (they are written
    densely), and each input read once where the function needs it:
      * a node field on the active node-levels, ``z < nlev_nod - 1``, and
        a limited interface field on ``z < nlev_nod``, where the kernel's
        result reads it; a factor or bound gathered through the mesh on the
        node-levels the gathering edges or elements reach;
      * an edge field on its active levels, ``z < nlev_edge``, where only
        those are gathered;
      * in full, an input whose values an output copies where the row is
        inactive (``fct_adf_v`` in K2 and K12, ``fct_adf_h`` in K3 and K34,
        the increments ``del_ttf_adv*`` or ``fct_LO`` in stage c);
      * the live slots of the incidence rows (``nd_num`` per node), and the
        per-node, per-edge and per-element rows; the connectivity once, in
        one form (K34: the incidence rows of its node sum, not the edge
        rows and ranges its tiling also reads);
      * ``b3h_fixup``: only its edges ``ids`` (a duplicated id read once);
      * ``update_fixup`` (K4 with K3fix folded in, on a part with owned
        columns ``owned = (lo, hi)``): K4's bytes, where the limited flux
        of each fix edge (a live slot of an owned node whose other
        endpoint ``nd_other`` lies outside, read on every live slot) is
        replaced by its raw flux, both factors of both its endpoints on
        its active levels, and its limited flux (and residual) written on
        those levels;
      * ``stress2rhs``: the ``ea`` row of the element slab for every
        element and its other 10 rows for the elements with ice
        (``slab[3] != 0``), and ``rhs_a`` / ``rhs_m`` where
        ``inv_areamass > 0``; both tensors must be given.
    Tracers: the per-tracer inputs and outputs count ``tracers`` times;
    what every tracer shares (the connectivity and per-node, per-edge
    rows, ``area_inv``, ``hnode``, ``hnode_new``, the fix-edge ids) once.
    Only the seven wrappers with a tracer axis take ``tracers`` > 1.
    Operations: the arithmetic and comparisons of the kernel's loop body
    per active (node, level), (incident edge, level), (edge, level),
    (element, level) or incidence, per tracer; far below the bytes' time
    on an H100 for every kernel."""
    if tracers < 1 or (tracers > 1 and name in ("limit_fused", "a2",
                                                "stress2rhs")):
        raise ValueError(f"{name} takes no {tracers} tracers")
    f = torch.empty((), dtype=md.dtype).element_size()
    L, N, Ed, E = md.n_layers, md.n_nodes, md.n_edges, md.n_elems
    node, iface, edge, elem = L * N * f, (L + 1) * N * f, L * Ed * f, L * E * f
    nod = int(md.node_mask.sum())  # active node-levels
    vint = int(md.nlev_nod.clamp(min=0).sum())  # interfaces stage c reads
    edge_act = int(md.nlev_edge.sum())  # active edge-levels
    live = (torch.arange(md.nd_idx.shape[1], device=md.nd_idx.device)[None, :]
            < md.nd_num[:, None])
    n_live = int(live.sum())  # live incidence slots
    inc_lev = int(md.nd_lev.sum())  # active (incident edge, level) pairs
    # plus/minus (K34) as the node rows' edges gather them: the node itself
    # and each neighbour, up to the edge's levels
    owner = torch.arange(N, device=live.device)[:, None].expand_as(live)
    fac = _gathered_levels(
        N, torch.cat([owner[live], md.nd_other[live]]),
        torch.cat([md.nd_lev[live], md.nd_lev[live]]))
    inc32, inc8, row = n_live * 4, n_live, N * 4
    # stage c: node inputs read on active rows (hnode, hnode_new, area_inv
    # shared), and the inputs the outputs copy on inactive rows; the
    # limited vertical flux on its interfaces
    if iter_yn:
        c_shared = 2 * nod * f  # hnode_new, area_inv
        c_in = node + vint * f  # fct_LO; the limited vertical flux
        c_out = node
    else:
        c_shared = 3 * nod * f  # hnode, hnode_new, area_inv
        c_in = 2 * nod * f + 2 * node + vint * f  # ttf, fct_LO; del_*
        c_out = 2 * node
    res_v = iface if iter_yn else 0
    res_h = edge if iter_yn else 0
    # (shared bytes, bytes a tracer, operations a tracer)
    if name == "bounds":
        io = (2 * inc32 + 2 * row, 2 * nod * f + 2 * node,
              12 * nod + 4 * inc_lev)
    elif name == "limit":
        io = (nod * f + 2 * inc32 + inc8 + 2 * row,
              iface + 2 * nod * f + edge_act * f + 2 * node + iface + res_v,
              24 * nod + 4 * inc_lev)
    elif name == "limit_fused":
        io = (nod * f + 3 * inc32 + inc8 + 2 * row,
              2 * nod * f + iface + edge_act * f + 4 * node + iface + res_v,
              36 * nod + 8 * inc_lev)
    elif name == "update_fused":
        # the connectivity once, as the incidence rows the node sum needs;
        # the kernel's edge rows (edges, nlev_edge, ed_ptr) repeat it for
        # its tiling and are not the function's bytes
        io = (c_shared + 3 * inc32 + inc8 + 2 * row,
              2 * fac * f + edge + c_in + c_out + edge + res_h,
              12 * nod + 12 * inc_lev)
    elif name == "update":
        io = (c_shared + 2 * inc32 + inc8 + 2 * row,
              edge_act * f + c_in + c_out, 12 * nod + 2 * inc_lev)
    elif name == "update_fixup":
        if owned is None:
            raise ValueError("update_fixup needs the owned columns")
        from fesom2_accelerate_tpu_torch.ops.cuda.kernels import fixup_edges

        u = fixup_edges(md, owned).long()
        lev = md.nlev_edge[u]
        gath = _gathered_levels(N, md.edges.reshape(Ed, 2)[u],
                                lev[:, None].expand(-1, 2))
        fix_act = int(lev.sum())  # the fix edges' active levels
        io = (c_shared + 3 * inc32 + inc8 + 2 * row,
              edge_act * f + 2 * gath * f + c_in + c_out
              + (2 if iter_yn else 1) * fix_act * f,
              12 * nod + 2 * inc_lev + 8 * fix_act)
    elif name == "b3h":
        ends = md.edges.reshape(Ed, 2)
        gath = _gathered_levels(N, ends, md.nlev_edge[:, None].expand(Ed, 2))
        io = (12 * Ed, 2 * gath * f + edge + edge + res_h, 8 * edge_act)
    elif name == "b3h_fixup":
        if ids is None:
            raise ValueError("b3h_fixup needs the edge ids it runs on")
        u = torch.unique(ids.long())
        ends = md.edges.reshape(Ed, 2)[u]
        lev = md.nlev_edge[u]
        gath = _gathered_levels(N, ends, lev[:, None].expand(-1, 2))
        per = (2 if iter_yn else 1) * L * len(u) * f
        io = (4 * len(ids) + 12 * len(u),
              2 * gath * f + L * len(u) * f + per, 8 * int(lev.sum()))
    elif name == "a2":
        depth = (md.nlev_elem - 1).clamp(min=0)
        gath = _gathered_levels(N, md.elem_nodes,
                                depth[:, None].expand(-1, 3))
        io = (16 * E, 2 * gath * f + 2 * elem, 4 * int(depth.sum()))
    elif name == "stress2rhs":
        if slab is None or inv_areamass is None:
            raise ValueError("stress2rhs needs its slab and inv_areamass")
        iced = slab[3] != 0  # the ea row (ops/cuda/kernels.py SLAB_ROWS)
        codes = md.ne_slot[md.ne_slot >= 0].long()
        n_inc = int(iced[codes // 3].sum())  # incidences of iced elements
        n_mass = int((inv_areamass > 0).sum())
        io = (0, E * f + 10 * int(iced.sum()) * f + 4 * codes.numel()
              + N * f + 2 * n_mass * f + 2 * N * f, 14 * n_inc + 6 * N)
    else:
        raise ValueError(f"no model for kernel {name!r}")
    shared, per_tracer, ops = io
    return shared + tracers * per_tracer, tracers * ops


def bound_ms(nbytes: int, ops: int = 0, dtype: torch.dtype = torch.float32,
             peak: str = "h100_sxm") -> tuple[float, str]:
    """The least time (ms) the card ``peak`` names could take to move
    ``nbytes`` and do ``ops`` operations of ``dtype``: the larger of the two
    times, and which of them ("bytes" or "operations") it is."""
    p = PEAKS[peak]
    t_bytes = nbytes / p["bytes_per_s"] * 1e3
    t_ops = ops / p[str(dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the kernels each form of the step launches, once each (ops/cuda/step.py):
# the four single-device forms (fuse_k12 x fuse_k34), and a part of the
# split sharded step, whose K4-fix limits again the edges with an endpoint
# outside the part's owned columns
STEP_FORMS = {
    "K1->K2->K34": ("bounds", "limit", "update_fused"),
    "K12->K34": ("limit_fused", "update_fused"),
    "K1->K2->K3->K4": ("bounds", "limit", "b3h", "update"),
    "K12->K3->K4": ("limit_fused", "b3h", "update"),
    "K1->K2->K3->K4fix": ("bounds", "limit", "b3h", "update_fixup"),
}


def step_io(md, cfg, form: str, tracers: int = 1,
            owned: tuple | None = None) -> tuple[int, int]:
    """(bytes, operations) of one step of ``form`` (a key of
    ``STEP_FORMS``) on mesh data ``md`` for ``tracers`` tracers, in the
    mode of ``cfg`` (``iter_yn``): the sum of :func:`kernel_io` over the
    kernels the form launches.  ``owned`` is the part's owned columns, for
    K4-fix (form "K1->K2->K3->K4fix"); a sharded step is the sum over its
    parts.  What the step's functions need, not what the card moved: each
    kernel's inputs count once, so a share of a roof above 1 means a wrong
    count or a wrong time.

    The port's counterpart of the JAX ``fct_ale_step_bytes_physical``,
    which counts the TPU's packed layout (slabs, windows, pad rows); the
    port's kernels read natural shapes, so the port counts the functions'
    bytes."""
    if form not in STEP_FORMS:
        raise ValueError(f"form must be one of {sorted(STEP_FORMS)}, got "
                         f"{form!r}")
    nbytes = ops = 0
    for name in STEP_FORMS[form]:
        b, o = kernel_io(md, name, cfg.iter_yn, owned=owned, tracers=tracers)
        nbytes += b
        ops += o
    return nbytes, ops


def measure_stream_bandwidth(n_bytes: int = 2 ** 29, iters: int = 20,
                             reps: int = 3, device="cuda") -> float:
    """The card's measured streaming rate, bytes/s: a triad chained
    ``iters`` times over float32 arrays of ``n_bytes`` each, 2 reads and 1
    write a pass (``c = a + 0.5 * b``, one ``torch.add(a, b, alpha=0.5,
    out=c)`` kernel, then ``a`` and ``c`` swap), timed by CUDA events,
    best of ``reps`` after a warm-up -> ``3 * n_bytes * iters / t``.  The
    counterpart of the JAX ``runtime/profiling.py`` function of the same
    name, the same triad; the roof a step's :func:`step_io` share is taken
    against.  Arrays of 512 MiB are far above the H100's 50 MB L2, so every
    pass streams from HBM.  Raises ValueError without a CUDA device."""
    dev = require_cuda(device)
    n = n_bytes // 4
    with torch.cuda.device(dev):
        a = torch.ones(n, dtype=torch.float32, device=dev)
        b = torch.ones_like(a)
        c = torch.empty_like(a)

        def passes():
            nonlocal a, c
            for _ in range(iters):
                torch.add(a, b, alpha=0.5, out=c)
                a, c = c, a

        passes()  # warm-up
        best = math.inf
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            passes()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        del a, b, c
    return 3.0 * 4 * n * iters / best
