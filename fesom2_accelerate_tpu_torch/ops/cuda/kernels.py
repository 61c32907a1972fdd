"""Wrappers of the CUDA kernels, each beside its plain PyTorch version.

============  ==============================================  ================
wrapper       replaces (JAX package, Pallas)                  plain version
============  ==============================================  ================
bounds        kernels.py:bounds_dia_dma_pallas (K1); also     bounds_ref
              bounds_pallas, bounds_dia_pallas
limit         kernels_packed.py:limit_packed_pallas (K2);     limit_ref
              also kernels.py:limit_pallas
limit_fused   kernels_packed.py:limit_fused_pallas (K12,      limit_fused_ref
              K1 and K2 in one kernel)
update_fused  kernels_packed.py:update_fused_pallas (K34)     update_fused_ref
b3h           kernels_packed.py:b3h_packed_pallas and         b3h_ref
              kernels.py:b3h_pallas (split K3)
b3h_fixup     kernels_packed.py:b3h_packed_fixup_pallas and   b3h_fixup_ref
              kernels.py:b3h_fixup_pallas (K3 fixup)
update        kernels_packed.py:update_packed_pallas and      update_ref
              kernels.py:update_pallas (split K4)
a2            kernels.py:a2_pallas (standalone a2, the         a2_ref
              tuning harness's)
stress2rhs    kernels.py:stress2rhs_pallas and                stress2rhs_ref
              kernels_packed.py:stress2rhs_packed_pallas
============  ==============================================  ================

All but the last are in ``fct_ale.cu``.  The FCT-ALE step runs K1 -> K2 ->
K34 on one device by default, K12 in place of K1 -> K2 and K3 -> K4 in
place of K34 on request (``ops/cuda/step.py``), or K1 -> K2 -> K3 -> halo
exchange -> K3fix -> K4 in a sharded step (``parallel/step_sharded.py``);
a2 runs in the tuning harness (``utils/tuning.py``).  The last is the
sea-ice EVP stress divergence (``stress2rhs.cu``).  A wrapper given
tensors on the CPU returns its plain version, built from
:mod:`fesom2_accelerate_tpu_torch.ops.stages`
(the stress2rhs one is written out here, in the kernel's summation order).
Given CUDA tensors it checks device, dtype, shape and contiguity, allocates
its outputs with ``torch.empty`` (``b3h_fixup`` writes in place into
``b3h``'s), launches the kernel on the current stream of the mesh data's
device, raises if the launcher reports an error, and adds one to its
``launches`` count.  Any other device raises.  Nothing falls back.

Every wrapper takes ``threads``, the CUDA block size (one of ``THREADS``,
default 128): the launch configuration the tuning harness sweeps.  The
plain version ignores it; a value outside ``THREADS`` raises on any device.

The tracer axis: ``bounds``, ``limit``, ``update_fused``, ``b3h``,
``b3h_fixup`` and ``update`` take their per-tracer fields either 2-D (one
tracer: [L, N], [L+1, N], [L, Ed]) or 3-D with a leading tracer axis
([Tb, L, N], ...), as the Pallas kernels they replace take ``Tb``; their
outputs then carry the same axis.  ``hnode``, ``hnode_new`` and the mesh
data are shared by all tracers and stay 2-D.  One launch covers every
tracer and counts once; each tracer's outputs are bit-identical to a
launch on that tracer alone.  ``limit_fused``, ``a2`` and ``stress2rhs``
take no tracer axis, as their Pallas kernels take none.  Every wrapper
checks its inputs' shapes on the CPU as well, so a wrong shape raises
there too.

Tolerances against the plain versions, on the card: ``bounds``, ``a2``,
``b3h`` and ``b3h_fixup`` are bit-exact (max/min, selects, one subtraction
or one product per output), and so are the edge outputs of
``update_fused`` and the bounds that ``limit_fused`` returns; on the card
``update_fused`` gives the bits of ``b3h`` then ``update``, and
``limit_fused`` those of ``bounds`` then ``limit``.  ``limit``,
``limit_fused``'s other outputs, ``update_fused``'s node outputs,
``update`` and ``stress2rhs`` agree to relerr <= 1e-6 in float32 and
<= 1e-12 in float64, relerr =
max|a-b| / max(max|b|, 1): nvcc contracts a*b+c into one FMA rounding, and
the kernels sum the incident edges (or elements) in another order.  Every
kernel sums in a fixed order, without atomics: two launches on the same
inputs give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from fesom2_accelerate_tpu_torch.ops import stages
from fesom2_accelerate_tpu_torch.ops.cuda import build
from fesom2_accelerate_tpu_torch.ops.meshdata import MeshData

TOLERANCE = {torch.float32: 1e-6, torch.float64: 1e-12}

# incidence slots a kernel keeps in registers (kMaxDegree in fct_ale.cu,
# kMaxSlots in stress2rhs.cu)
MAX_DEGREE = 16

_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}

# block sizes the kernels are instantiated for, and the default
THREADS = (64, 128, 256, 512)
DEFAULT_THREADS = 128


# incidence rows wider than 8 slots have node-kernel instances for blocks of
# at most this many threads (kMaxWideThreads in fct_ale.cu: more would
# spill their registers)
MAX_WIDE_THREADS = 128


def check_threads(threads: int, slots: int = 0) -> int:
    """``threads`` if the kernels have an instance for that block size and
    an incidence row of ``slots`` slots (0: a kernel without one)."""
    if threads not in THREADS:
        raise ValueError(f"threads must be one of {THREADS}, got {threads}")
    if slots > 8 and threads > MAX_WIDE_THREADS:
        raise ValueError(f"incidence rows of {slots} > 8 slots take threads "
                         f"<= {MAX_WIDE_THREADS}, got {threads}")
    return int(threads)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _tracers(x: torch.Tensor) -> int | None:
    """Tb of a call from one of its per-tracer inputs: the leading axis of
    a 3-D input, None for a 2-D one (a single tracer, no axis)."""
    if x.dim() != 3:
        return None
    if x.shape[0] < 1:
        raise ValueError(f"a tracer axis needs at least one tracer, got "
                         f"shape {tuple(x.shape)}")
    return int(x.shape[0])


def _rows(tb: int | None, *shape: int) -> tuple:
    """The shape of a per-tracer field of one tracer's ``shape``."""
    return shape if tb is None else (tb, *shape)


def _shapes(named: dict) -> None:
    """Raise unless every tensor has the shape given (None: absent)."""
    for name, (t, shape) in named.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")


def _stack(outs) -> tuple:
    """Per-tracer output tuples -> one tuple of [Tb, ...] tensors (an
    output that is None for every tracer stays None)."""
    return tuple(None if o[0] is None else torch.stack(o)
                 for o in zip(*outs))


def _check(md: MeshData, named: dict, slots: int) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor of the mesh
    data's dtype, on the mesh data's device, with the shape given, and the
    kernel's incidence rows (``slots`` wide) fit its registers."""
    if slots > MAX_DEGREE:
        raise ValueError(f"node degree {slots} exceeds the kernels' "
                         f"{MAX_DEGREE} incidence slots")
    dev = md.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernels need mesh data on a CUDA device, "
                         f"got {dev}")
    for name, (t, shape) in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, mesh data on {dev}")
        if t.dtype != md.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            f"{md.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return dev


def _launch(name: str, md: MeshData, dev: torch.device, threads: int,
            *args) -> None:
    fn = getattr(build.library(), name + _SUFFIX[md.dtype])
    # the launcher selects dev; the guard gives torch its device back after
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, threads, dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _mesh_ptrs(md: MeshData, *names) -> list:
    return [getattr(md, n).data_ptr() for n in names]


# --------------------------------------------------------------------------
# K1 bounds: a1 + a2 + a3 -> fct_ttf_max, fct_ttf_min
# --------------------------------------------------------------------------


def bounds_ref(md: MeshData, fct_LO, ttf, vlimit: int):
    """a1, the element-cluster bounds through the edge-neighbour identity
    (for every vlimit, as the kernel computes them), then the vlimit window
    and ``- fct_LO``.  3-D inputs: each tracer on its own, stacked."""
    if fct_LO.dim() == 3:
        return _stack(bounds_ref(md, lo, t, vlimit)
                      for lo, t in zip(fct_LO, ttf))
    tmax, tmin = stages.a1(md, fct_LO, ttf)
    cmax, cmin = stages._cluster_reduce_via_edges(md, tmax, tmin)
    if vlimit == 1:
        return stages._a3_vlimit1_from_cluster(md, cmax, cmin, fct_LO)
    return stages._a3_vlimit23_from_cluster(md, cmax, cmin, tmax, fct_LO,
                                            widen=(vlimit == 2))


def bounds(md: MeshData, fct_LO, ttf, vlimit: int, *,
           threads: int = DEFAULT_THREADS):
    """K1 -> (fct_ttf_max, fct_ttf_min), each [L, N] (or [Tb, L, N] for
    inputs with a tracer axis)."""
    threads = check_threads(threads, md.nd_idx.shape[1])
    L, N = md.n_layers, md.n_nodes
    tb = _tracers(fct_LO)
    checks = dict(fct_LO=(fct_LO, _rows(tb, L, N)),
                  ttf=(ttf, _rows(tb, L, N)))
    if _on_cpu(fct_LO, ttf, md.area_inv):
        _shapes(checks)
        return bounds_ref(md, fct_LO, ttf, vlimit)
    if vlimit not in (1, 2, 3):
        raise ValueError(f"vlimit must be 1, 2 or 3, got {vlimit}")
    dev = _check(md, checks, md.nd_idx.shape[1])
    tmax = torch.empty(_rows(tb, L, N), dtype=md.dtype, device=dev)
    tmin = torch.empty_like(tmax)
    _launch("fct_bounds", md, dev, threads, fct_LO.data_ptr(),
            ttf.data_ptr(),
            *_mesh_ptrs(md, "nd_other", "nd_lev", "nd_num", "nlev_nod"),
            tmax.data_ptr(), tmin.data_ptr(), L, N, md.nd_idx.shape[1],
            vlimit, tb or 1)
    bounds.launches += 1
    return tmax, tmin


bounds.launches = 0


# --------------------------------------------------------------------------
# K2 limit: b1 vertical + b1 horizontal + b2 + b3 vertical
# --------------------------------------------------------------------------


def limit_ref(md: MeshData, fct_adf_v, tmax, tmin, fct_adf_h, dt: float,
              flux_eps: float, iter_yn: bool):
    if fct_adf_v.dim() == 3:
        return _stack(limit_ref(md, av, tx, tn, ah, dt, flux_eps, iter_yn)
                      for av, tx, tn, ah in zip(fct_adf_v, tmax, tmin,
                                                fct_adf_h))
    plus, minus = stages.b1_vertical(md, fct_adf_v)
    plus, minus = stages.b1_horizontal(md, plus, minus, fct_adf_h)
    plus, minus = stages.b2(md, plus, minus, tmax, tmin, dt, flux_eps)
    adf_v_lim, adf_v_res = stages.b3_vertical(md, plus, minus, fct_adf_v,
                                              iter_yn)
    return plus, minus, adf_v_lim, adf_v_res


def limit(md: MeshData, fct_adf_v, tmax, tmin, fct_adf_h, dt: float,
          flux_eps: float, iter_yn: bool, *, threads: int = DEFAULT_THREADS):
    """K2 -> (fct_plus [L, N], fct_minus [L, N], limited fct_adf_v
    [L+1, N], its residual [L+1, N] when ``iter_yn`` else None), each with
    the inputs' tracer axis when they have one."""
    threads = check_threads(threads, md.nd_idx.shape[1])
    L, N, Ed = md.n_layers, md.n_nodes, md.n_edges
    tb = _tracers(fct_adf_v)
    checks = dict(fct_adf_v=(fct_adf_v, _rows(tb, L + 1, N)),
                  tmax=(tmax, _rows(tb, L, N)), tmin=(tmin, _rows(tb, L, N)),
                  fct_adf_h=(fct_adf_h, _rows(tb, L, Ed)))
    if _on_cpu(fct_adf_v, tmax, tmin, fct_adf_h, md.area_inv):
        _shapes(checks)
        return limit_ref(md, fct_adf_v, tmax, tmin, fct_adf_h, dt, flux_eps,
                         iter_yn)
    dev = _check(md, checks, md.nd_idx.shape[1])
    plus = torch.empty(_rows(tb, L, N), dtype=md.dtype, device=dev)
    minus = torch.empty_like(plus)
    adf_v_lim = torch.empty(_rows(tb, L + 1, N), dtype=md.dtype, device=dev)
    adf_v_res = torch.empty_like(adf_v_lim) if iter_yn else None
    _launch("fct_limit", md, dev, threads, fct_adf_v.data_ptr(),
            tmax.data_ptr(),
            tmin.data_ptr(), fct_adf_h.data_ptr(),
            *_mesh_ptrs(md, "area_inv", "nd_idx", "nd_lev", "nd_sgn",
                        "nd_num", "nlev_nod"),
            plus.data_ptr(), minus.data_ptr(), adf_v_lim.data_ptr(),
            _ptr(adf_v_res), L, N, Ed, md.nd_idx.shape[1], float(dt),
            float(flux_eps), tb or 1)
    limit.launches += 1
    return plus, minus, adf_v_lim, adf_v_res


limit.launches = 0


# --------------------------------------------------------------------------
# K12 limit_fused: K1 and K2 in one pass over the nodes
# --------------------------------------------------------------------------


def limit_fused_ref(md: MeshData, fct_LO, ttf, fct_adf_v, fct_adf_h,
                    vlimit: int, dt: float, flux_eps: float, iter_yn: bool):
    """K1's plain version, then K2's on its bounds."""
    tmax, tmin = bounds_ref(md, fct_LO, ttf, vlimit)
    return (tmax, tmin) + limit_ref(md, fct_adf_v, tmax, tmin, fct_adf_h, dt,
                                    flux_eps, iter_yn)


def limit_fused(md: MeshData, fct_LO, ttf, fct_adf_v, fct_adf_h,
                vlimit: int, dt: float, flux_eps: float, iter_yn: bool, *,
                threads: int = DEFAULT_THREADS):
    """K12 -> (fct_ttf_max, fct_ttf_min, fct_plus, fct_minus, limited
    fct_adf_v, its residual or None): :func:`bounds` and :func:`limit` in
    one launch on tiles of TILE_NODES nodes x LIMIT_FUSED_LEVELS levels
    (``ops/meshdata.py``), without the bounds' round trip through device
    memory.  One tracer only: H-K12 has no tracer axis."""
    threads = check_threads(threads, md.nd_idx.shape[1])
    L, N, Ed = md.n_layers, md.n_nodes, md.n_edges
    checks = dict(fct_LO=(fct_LO, (L, N)), ttf=(ttf, (L, N)),
                  fct_adf_v=(fct_adf_v, (L + 1, N)),
                  fct_adf_h=(fct_adf_h, (L, Ed)))
    if _on_cpu(fct_LO, ttf, fct_adf_v, fct_adf_h, md.area_inv):
        _shapes(checks)
        return limit_fused_ref(md, fct_LO, ttf, fct_adf_v, fct_adf_h, vlimit,
                               dt, flux_eps, iter_yn)
    if vlimit not in (1, 2, 3):
        raise ValueError(f"vlimit must be 1, 2 or 3, got {vlimit}")
    dev = _check(md, checks, md.nd_idx.shape[1])
    tmax = torch.empty((L, N), dtype=md.dtype, device=dev)
    tmin = torch.empty_like(tmax)
    plus = torch.empty_like(tmax)
    minus = torch.empty_like(tmax)
    adf_v_lim = torch.empty((L + 1, N), dtype=md.dtype, device=dev)
    adf_v_res = torch.empty_like(adf_v_lim) if iter_yn else None
    _launch("fct_limit_fused", md, dev, threads, fct_LO.data_ptr(),
            ttf.data_ptr(), fct_adf_v.data_ptr(), fct_adf_h.data_ptr(),
            *_mesh_ptrs(md, "area_inv", "nd_idx", "nd_other", "nd_lev",
                        "nd_sgn", "nd_num", "nlev_nod"),
            tmax.data_ptr(), tmin.data_ptr(), plus.data_ptr(),
            minus.data_ptr(), adf_v_lim.data_ptr(), _ptr(adf_v_res), L, N,
            Ed, md.nd_idx.shape[1], vlimit, float(dt), float(flux_eps))
    limit_fused.launches += 1
    return tmax, tmin, plus, minus, adf_v_lim, adf_v_res


limit_fused.launches = 0


# --------------------------------------------------------------------------
# K34 update_fused: b3 horizontal + stage c
# --------------------------------------------------------------------------


def update_fused_ref(md: MeshData, fct_plus, fct_minus, adf_v_lim,
                     fct_adf_h, ttf, hnode, hnode_new, fct_LO,
                     del_ttf_advvert, del_ttf_advhoriz, dt: float,
                     iter_yn: bool):
    adf_h_lim, adf_h_res = b3h_ref(md, fct_plus, fct_minus, fct_adf_h,
                                   iter_yn)
    o1, o2 = update_ref(md, adf_v_lim, adf_h_lim, ttf, hnode, hnode_new,
                        fct_LO, del_ttf_advvert, del_ttf_advhoriz, dt,
                        iter_yn)
    return o1, o2, adf_h_lim, adf_h_res


def _stage_c_checks(tb, L: int, N: int, ttf, hnode, hnode_new, fct_LO,
                    del_ttf_advvert, del_ttf_advhoriz) -> dict:
    """Shapes of stage c's node inputs: per-tracer ones with the call's
    tracer axis, ``hnode`` and ``hnode_new`` shared [L, N]."""
    return dict(ttf=(ttf, _rows(tb, L, N)), hnode=(hnode, (L, N)),
                hnode_new=(hnode_new, (L, N)),
                fct_LO=(fct_LO, _rows(tb, L, N)),
                del_ttf_advvert=(del_ttf_advvert, _rows(tb, L, N)),
                del_ttf_advhoriz=(del_ttf_advhoriz, _rows(tb, L, N)))


def update_fused(md: MeshData, fct_plus, fct_minus, adf_v_lim, fct_adf_h,
                 ttf, hnode, hnode_new, fct_LO, del_ttf_advvert,
                 del_ttf_advhoriz, dt: float, iter_yn: bool, *,
                 threads: int = DEFAULT_THREADS):
    """K34 -> (o1, o2, limited fct_adf_h [L, Ed], its residual), each with
    the inputs' tracer axis when they have one.

    Non-iterative: o1, o2 are the new ``del_ttf_advvert`` and
    ``del_ttf_advhoriz``, and the residual is None.  Iterative: o1 is the
    new ``fct_LO``, o2 is None, and the residual is [L, Ed].  Every edge
    output is written once, by the block of the node tile in which the
    edge starts (``md.ed_ptr``, which raises unless the mesh's edges are
    sorted so); the kernel keeps ``md.tile_edges`` limited fluxes a level
    in shared memory."""
    threads = check_threads(threads, md.nd_idx.shape[1])
    L, N, Ed = md.n_layers, md.n_nodes, md.n_edges
    tb = _tracers(fct_plus)
    checks = dict(fct_plus=(fct_plus, _rows(tb, L, N)),
                  fct_minus=(fct_minus, _rows(tb, L, N)),
                  adf_v_lim=(adf_v_lim, _rows(tb, L + 1, N)),
                  fct_adf_h=(fct_adf_h, _rows(tb, L, Ed)),
                  **_stage_c_checks(tb, L, N, ttf, hnode, hnode_new, fct_LO,
                                    del_ttf_advvert, del_ttf_advhoriz))
    if _on_cpu(fct_plus, fct_minus, adf_v_lim, fct_adf_h, ttf, hnode,
               hnode_new, fct_LO, del_ttf_advvert, del_ttf_advhoriz,
               md.area_inv):
        _shapes(checks)
        return update_fused_ref(md, fct_plus, fct_minus, adf_v_lim,
                                fct_adf_h, ttf, hnode, hnode_new, fct_LO,
                                del_ttf_advvert, del_ttf_advhoriz, dt,
                                iter_yn)
    dev = _check(md, checks, md.nd_idx.shape[1])
    o1 = torch.empty(_rows(tb, L, N), dtype=md.dtype, device=dev)
    o2 = None if iter_yn else torch.empty_like(o1)
    adf_h_lim = torch.empty(_rows(tb, L, Ed), dtype=md.dtype, device=dev)
    adf_h_res = torch.empty_like(adf_h_lim) if iter_yn else None
    _launch("fct_update_fused", md, dev, threads, fct_plus.data_ptr(),
            fct_minus.data_ptr(), adf_v_lim.data_ptr(), fct_adf_h.data_ptr(),
            ttf.data_ptr(), hnode.data_ptr(), hnode_new.data_ptr(),
            fct_LO.data_ptr(), del_ttf_advvert.data_ptr(),
            del_ttf_advhoriz.data_ptr(),
            *_mesh_ptrs(md, "area_inv", "edges", "nlev_edge", "ed_ptr",
                        "nd_idx", "nd_other", "nd_lev", "nd_sgn", "nd_num",
                        "nlev_nod"),
            o1.data_ptr(), _ptr(o2), adf_h_lim.data_ptr(), _ptr(adf_h_res),
            L, N, Ed, md.nd_idx.shape[1], md.tile_edges, float(dt),
            int(iter_yn), tb or 1)
    update_fused.launches += 1
    return o1, o2, adf_h_lim, adf_h_res


update_fused.launches = 0


# --------------------------------------------------------------------------
# K3 b3h and K3fix b3h_fixup: b3 horizontal, alone (split K3 of a sharded
# step), and again on the halo-touching edges after the exchange
# --------------------------------------------------------------------------


def b3h_ref(md: MeshData, fct_plus, fct_minus, fct_adf_h, iter_yn: bool):
    if fct_plus.dim() == 3:
        return _stack(b3h_ref(md, p, m, ah, iter_yn)
                      for p, m, ah in zip(fct_plus, fct_minus, fct_adf_h))
    return stages.b3_horizontal(md, fct_plus, fct_minus, fct_adf_h, iter_yn)


def b3h(md: MeshData, fct_plus, fct_minus, fct_adf_h, iter_yn: bool, *,
        threads: int = DEFAULT_THREADS):
    """K3 -> (limited fct_adf_h [L, Ed], its residual [L, Ed] when
    ``iter_yn`` else None), for every edge, each with the inputs' tracer
    axis when they have one."""
    threads = check_threads(threads)
    L, N, Ed = md.n_layers, md.n_nodes, md.n_edges
    tb = _tracers(fct_plus)
    checks = dict(fct_plus=(fct_plus, _rows(tb, L, N)),
                  fct_minus=(fct_minus, _rows(tb, L, N)),
                  fct_adf_h=(fct_adf_h, _rows(tb, L, Ed)))
    if _on_cpu(fct_plus, fct_minus, fct_adf_h, md.area_inv):
        _shapes(checks)
        return b3h_ref(md, fct_plus, fct_minus, fct_adf_h, iter_yn)
    dev = _check(md, checks, 0)
    adf_h_lim = torch.empty(_rows(tb, L, Ed), dtype=md.dtype, device=dev)
    adf_h_res = torch.empty_like(adf_h_lim) if iter_yn else None
    _launch("fct_b3h", md, dev, threads, fct_plus.data_ptr(),
            fct_minus.data_ptr(),
            fct_adf_h.data_ptr(), *_mesh_ptrs(md, "edges", "nlev_edge"),
            adf_h_lim.data_ptr(), _ptr(adf_h_res), L, N, Ed, tb or 1)
    b3h.launches += 1
    return adf_h_lim, adf_h_res


b3h.launches = 0


def b3h_fixup_ref(md: MeshData, fct_plus, fct_minus, fct_adf_h, adf_h_lim,
                  adf_h_res, fix_ids, iter_yn: bool):
    if fct_plus.dim() == 3:
        # each tracer in place into its slice of the outputs
        for t in range(fct_plus.shape[0]):
            b3h_fixup_ref(md, fct_plus[t], fct_minus[t], fct_adf_h[t],
                          adf_h_lim[t], adf_h_res[t] if iter_yn else None,
                          fix_ids, iter_yn)
        return adf_h_lim, adf_h_res
    ids = fix_ids.long()
    lim, res = stages.b3_limit_edges(
        fct_plus, fct_minus, fct_adf_h.index_select(1, ids),
        md.edges.index_select(0, ids), md.edge_mask.index_select(1, ids),
        iter_yn)
    adf_h_lim.index_copy_(1, ids, lim)
    if iter_yn:
        adf_h_res.index_copy_(1, ids, res)
    return adf_h_lim, adf_h_res


def b3h_fixup(md: MeshData, fct_plus, fct_minus, fct_adf_h, adf_h_lim,
              adf_h_res, fix_ids, iter_yn: bool, *,
              threads: int = DEFAULT_THREADS):
    """K3fix: b3 horizontal again on the edges ``fix_ids`` (int32 [F], the
    same for every tracer), written in place into K3's outputs
    ``adf_h_lim`` (and ``adf_h_res`` when ``iter_yn``), which it returns.
    An empty id list launches nothing."""
    threads = check_threads(threads)
    L, N, Ed = md.n_layers, md.n_nodes, md.n_edges
    tb = _tracers(fct_plus)
    checks = dict(fct_plus=(fct_plus, _rows(tb, L, N)),
                  fct_minus=(fct_minus, _rows(tb, L, N)),
                  fct_adf_h=(fct_adf_h, _rows(tb, L, Ed)),
                  adf_h_lim=(adf_h_lim, _rows(tb, L, Ed)))
    if iter_yn:
        checks["adf_h_res"] = (adf_h_res, _rows(tb, L, Ed))
    if _on_cpu(fct_plus, fct_minus, fct_adf_h, adf_h_lim, fix_ids,
               md.area_inv):
        _shapes(checks)
        return b3h_fixup_ref(md, fct_plus, fct_minus, fct_adf_h, adf_h_lim,
                             adf_h_res, fix_ids, iter_yn)
    dev = _check(md, checks, 0)
    if (fix_ids.device != dev or fix_ids.dtype != torch.int32
            or fix_ids.dim() != 1 or not fix_ids.is_contiguous()):
        raise ValueError(f"fix_ids must be a contiguous 1-D int32 tensor on "
                         f"{dev}")
    n_ids = fix_ids.shape[0]
    if n_ids:
        _launch("fct_b3h_fixup", md, dev, threads, fct_plus.data_ptr(),
                fct_minus.data_ptr(), fct_adf_h.data_ptr(),
                *_mesh_ptrs(md, "edges", "nlev_edge"), fix_ids.data_ptr(),
                adf_h_lim.data_ptr(), _ptr(adf_h_res if iter_yn else None),
                L, N, Ed, n_ids, tb or 1)
        b3h_fixup.launches += 1
    return adf_h_lim, adf_h_res


b3h_fixup.launches = 0


# --------------------------------------------------------------------------
# K4 update: stage c from limited edge fluxes (split K4 of a sharded step)
# --------------------------------------------------------------------------


def update_ref(md: MeshData, adf_v_lim, adf_h_lim, ttf, hnode, hnode_new,
               fct_LO, del_ttf_advvert, del_ttf_advhoriz, dt: float,
               iter_yn: bool):
    if ttf.dim() == 3:
        return _stack(
            update_ref(md, av, ah, t, hnode, hnode_new, lo, dv, dh, dt,
                       iter_yn)
            for av, ah, t, lo, dv, dh in zip(adf_v_lim, adf_h_lim, ttf,
                                             fct_LO, del_ttf_advvert,
                                             del_ttf_advhoriz))
    if iter_yn:
        return stages.c_update_LO(md, fct_LO, adf_v_lim, adf_h_lim,
                                  hnode_new, dt), None
    return stages.c_update_solution(
        md, ttf, hnode, hnode_new, fct_LO, adf_v_lim, adf_h_lim,
        del_ttf_advvert, del_ttf_advhoriz, dt)


def update(md: MeshData, adf_v_lim, adf_h_lim, ttf, hnode, hnode_new,
           fct_LO, del_ttf_advvert, del_ttf_advhoriz, dt: float,
           iter_yn: bool, *, threads: int = DEFAULT_THREADS):
    """K4 -> (o1, o2) from the limited fluxes ``adf_v_lim`` [L+1, N] and
    ``adf_h_lim`` [L, Ed]; o1, o2 as in :func:`update_fused`, with the
    inputs' tracer axis when they have one."""
    threads = check_threads(threads, md.nd_idx.shape[1])
    L, N, Ed = md.n_layers, md.n_nodes, md.n_edges
    tb = _tracers(ttf)
    checks = dict(adf_v_lim=(adf_v_lim, _rows(tb, L + 1, N)),
                  adf_h_lim=(adf_h_lim, _rows(tb, L, Ed)),
                  **_stage_c_checks(tb, L, N, ttf, hnode, hnode_new, fct_LO,
                                    del_ttf_advvert, del_ttf_advhoriz))
    if _on_cpu(adf_v_lim, adf_h_lim, ttf, hnode, hnode_new, fct_LO,
               del_ttf_advvert, del_ttf_advhoriz, md.area_inv):
        _shapes(checks)
        return update_ref(md, adf_v_lim, adf_h_lim, ttf, hnode, hnode_new,
                          fct_LO, del_ttf_advvert, del_ttf_advhoriz, dt,
                          iter_yn)
    dev = _check(md, checks, md.nd_idx.shape[1])
    o1 = torch.empty(_rows(tb, L, N), dtype=md.dtype, device=dev)
    o2 = None if iter_yn else torch.empty_like(o1)
    _launch("fct_update", md, dev, threads, adf_v_lim.data_ptr(),
            adf_h_lim.data_ptr(), ttf.data_ptr(), hnode.data_ptr(),
            hnode_new.data_ptr(), fct_LO.data_ptr(),
            del_ttf_advvert.data_ptr(), del_ttf_advhoriz.data_ptr(),
            *_mesh_ptrs(md, "area_inv", "nd_idx", "nd_lev", "nd_sgn",
                        "nd_num", "nlev_nod"),
            o1.data_ptr(), _ptr(o2), L, N, Ed, md.nd_idx.shape[1],
            float(dt), int(iter_yn), tb or 1)
    update.launches += 1
    return o1, o2


update.launches = 0


# --------------------------------------------------------------------------
# A2 a2: element bounds (standalone a2 of the tuning harness)
# --------------------------------------------------------------------------


def a2_ref(md: MeshData, tmax, tmin, bignumber: float):
    return stages.a2(md, tmax, tmin, bignumber)


def a2(md: MeshData, tmax, tmin, bignumber: float, *,
       threads: int = DEFAULT_THREADS):
    """A2 -> (UV_max, UV_min), each [L, E]: the max / min of ``tmax`` /
    ``tmin`` [L, N] over each element's 3 nodes on its active levels
    (z < nlev_elem - 1), -bignumber / +bignumber below."""
    threads = check_threads(threads)
    L, N, E = md.n_layers, md.n_nodes, md.n_elems
    checks = dict(tmax=(tmax, (L, N)), tmin=(tmin, (L, N)))
    if _on_cpu(tmax, tmin, md.area_inv):
        _shapes(checks)
        return a2_ref(md, tmax, tmin, bignumber)
    dev = _check(md, checks, 0)
    uv_max = torch.empty((L, E), dtype=md.dtype, device=dev)
    uv_min = torch.empty_like(uv_max)
    _launch("fct_a2", md, dev, threads, tmax.data_ptr(), tmin.data_ptr(),
            *_mesh_ptrs(md, "elem_nodes", "nlev_elem"), uv_max.data_ptr(),
            uv_min.data_ptr(), L, N, E, float(bignumber))
    a2.launches += 1
    return uv_max, uv_min


a2.launches = 0


# --------------------------------------------------------------------------
# H-S2R stress2rhs: sea-ice EVP stress divergence, element slab -> U, V
# --------------------------------------------------------------------------

# rows of the element slab [SLAB_ROWS, E]: s11, s12, s22, ea, mf/3, then
# gradient_sca 0..5 from row _GRAD (kS11..kGrad in stress2rhs.cu)
SLAB_ROWS = 11
_GRAD = 5
# threads of H-S2R that share one node's incidence slots (kLanesPerNode in
# stress2rhs.cu): the kernel launches N * S2R_LANES threads
S2R_LANES = 2


def stress2rhs_ref(md: MeshData, slab, inv_areamass, rhs_a, rhs_m):
    """The kernel's function: for each node, its incidence slots in slot
    order, each adding the corner contribution of :func:`stages.stress2rhs`
    read from the slab, masked where the slot is padding or the element is
    ice-free (``ea == 0``).  The kernel sums the same terms in another
    order (S2R_LANES partial sums, slots k, k + S2R_LANES, ..., combined
    by warp shuffles)."""
    E = slab.shape[1]
    flat = slab.reshape(-1)
    U = torch.zeros_like(inv_areamass)
    V = torch.zeros_like(inv_areamass)
    for code in md.ne_slot.long():  # [N] per slot
        valid = code >= 0
        e = torch.where(valid, code, 0) // 3
        corner = torch.where(valid, code, 0) - 3 * e
        s11, s12, s22, ea, mf3 = torch.index_select(slab[:_GRAD], 1, e)
        g = torch.take(flat, (_GRAD + corner) * E + e)
        g3 = torch.take(flat, (_GRAD + 3 + corner) * E + e)
        live = valid & (ea != 0.0)
        U = U + torch.where(live, -ea * (s11 * g + s12 * g3 + s12 * mf3),
                            0.0)
        V = V + torch.where(live, -ea * (s12 * g + s22 * g3 - s11 * mf3),
                            0.0)
    has_mass = inv_areamass > 0.0
    return (torch.where(has_mass, U * inv_areamass + rhs_a, 0.0),
            torch.where(has_mass, V * inv_areamass + rhs_m, 0.0))


def stress2rhs(md: MeshData, slab, inv_areamass, rhs_a, rhs_m, *,
               threads: int = DEFAULT_THREADS):
    """H-S2R -> (U [N], V [N]) from the element slab [SLAB_ROWS, E] (rows
    s11, s12, s22, area * (ice_strength > 0), metric_factor / 3,
    gradient_sca 0..5) and the node rows [N]."""
    threads = check_threads(threads)
    N, E = md.n_nodes, md.n_elems
    checks = dict(slab=(slab, (SLAB_ROWS, E)),
                  inv_areamass=(inv_areamass, (N,)), rhs_a=(rhs_a, (N,)),
                  rhs_m=(rhs_m, (N,)))
    if _on_cpu(slab, inv_areamass, rhs_a, rhs_m, md.area_inv):
        _shapes(checks)
        return stress2rhs_ref(md, slab, inv_areamass, rhs_a, rhs_m)
    if 3 * E + 2 > torch.iinfo(torch.int32).max:
        raise ValueError(f"{E} elements overflow the int32 slot codes")
    dev = _check(md, checks, md.ne_slot.shape[0])
    out = torch.empty((2, N), dtype=md.dtype, device=dev)
    _launch("stress2rhs", md, dev, threads, slab.data_ptr(),
            md.ne_slot.data_ptr(),
            inv_areamass.data_ptr(), rhs_a.data_ptr(), rhs_m.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), N, E, md.ne_slot.shape[0])
    stress2rhs.launches += 1
    return out[0], out[1]


stress2rhs.launches = 0

WRAPPERS = (bounds, limit, limit_fused, update_fused, b3h, b3h_fixup, update,
            a2, stress2rhs)


# the kernels the occupancy query answers for, in the order of its ids
# (OccupancyKernel in fct_ale.cu)
OCCUPANCY = ("bounds", "limit", "update_fused", "b3h", "update",
             "limit_fused")


def occupancy(md: MeshData, name: str, *,
              threads: int = DEFAULT_THREADS) -> dict:
    """How kernel ``name`` (one of OCCUPANCY) fills the card of ``md`` when
    launched at ``md``'s shapes for one tracer: ``blocks_per_sm`` resident
    blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor), ``grid_blocks``
    and ``waves`` = grid blocks / (blocks per SM x SMs).  CUDA only."""
    threads = check_threads(threads, md.nd_idx.shape[1])
    dev = _check(md, {}, md.nd_idx.shape[1])
    out = (ctypes.c_int * 2)()
    fn = getattr(build.library(), "fct_occupancy" + _SUFFIX[md.dtype])
    with torch.cuda.device(dev):
        rc = fn(OCCUPANCY.index(name), md.n_layers, md.n_nodes, md.n_edges,
                md.nd_idx.shape[1],
                md.tile_edges if name == "update_fused" else 0,
                ctypes.addressof(out), threads, dev.index or 0)
    if rc != 0:
        raise RuntimeError(f"occupancy of {name} failed: CUDA error {rc}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm, grid = out[0], out[1]
    return dict(blocks_per_sm=per_sm, grid_blocks=grid,
                waves=grid / (per_sm * sms) if per_sm else float("inf"))


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
