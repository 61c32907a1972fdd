"""ctypes bindings to the port's native mesh core and CPU golden reference
(``native/fesom2_torch_core.cpp``).

Counterpart of ``fesom2_accelerate_tpu/mesh/native.py``, with its names:
``load``, ``available``, ``build_edges``, ``ragged_to_padded`` and
``NativeReference``, plus :func:`stress2rhs` over ``f2t_stress2rhs``.  The
C++ library is a second implementation of both the topology derivation
and the pinned FCT-ALE semantics, independent of the numpy oracle
(``ops/oracle.py``) and of the CUDA kernels: the reference's own L5 layer.

The library is built by ``native/build.py`` at its first use (g++, into
``native/_build/``).  Unlike the JAX module, :func:`load` never returns
None: a missing compiler or a failed build raises, with the compiler's
message.  :func:`available` says only whether a compiler exists.  The
library is loaded with ctypes' default ``RTLD_LOCAL``, so its ``f2t_*``
names stay apart from those of the host-embedding shim
(``native/fesom2_torch_host.cpp``) in the same process.

The port's topology (``mesh/topology.py``) is numpy and never calls this
module, as the JAX topology never calls its native core.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from fesom2_accelerate_tpu_torch.native import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_F64 = ctypes.c_double

# every function of the core's extern "C" block: (restype, argtypes)
_SIGNATURES = {
    "f2t_count_edges": (_I64, (_P, _I64, _I64)),
    "f2t_build_edges": (_I32, (_P, _I64, _I64, _P, _P)),
    "f2t_ragged_to_padded": (_I32, (_P, _P, _P, _I64, _I64, _I32, _P, _P,
                                    _P)),
    "f2t_levels": (None, (_P, _P, _I64, _I64, _P, _I64, _P, _P)),
    "f2t_a1": (None, (_I64, _I64, _P, _P, _P, _P, _P)),
    "f2t_a2": (None, (_I64, _I64, _I64, _P, _P, _P, _P, _F64, _P, _P)),
    "f2t_a3_vlimit1": (None, (_I64, _I64, _I64, _P, _P, _P, _I32, _P, _P,
                              _P, _P, _P)),
    "f2t_b1": (None, (_I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P)),
    "f2t_b2": (None, (_I64, _I64, _P, _P, _P, _P, _F64, _F64, _P, _P)),
    "f2t_b3_vertical": (None, (_I64, _I64, _P, _P, _P, _P, _I32, _P)),
    "f2t_b3_horizontal": (None, (_I64, _I64, _I64, _P, _P, _P, _P, _P, _I32,
                                 _P)),
    "f2t_c_update_solution": (None, (_I64, _I64, _I64, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _P, _F64, _P, _P)),
    "f2t_c_update_LO": (None, (_I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P,
                               _F64, _P)),
    "f2t_stress2rhs": (None, (_I64, _I64) + (_P,) * 13),
}


@functools.cache
def load() -> ctypes.CDLL:
    """The core's library, built at the first call; raises where it
    cannot be built."""
    lib = ctypes.CDLL(str(build.build_core()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    """Whether this host has a C++ compiler to build the core with."""
    return build.compiler() is not None


def _ptr(a, dtype):
    a = np.ascontiguousarray(a, dtype=dtype)
    return a, a.ctypes.data_as(_P)


def _out(a: np.ndarray):
    return a.ctypes.data_as(_P)


def build_edges(elem_nodes: np.ndarray):
    """Native edge derivation; same contract as topology._build_edges."""
    lib = load()
    elem_nodes, p_en = _ptr(elem_nodes, np.int32)
    if elem_nodes.ndim != 2 or elem_nodes.shape[1] != 3:
        raise ValueError(f"elem_nodes must be [E, 3], got {elem_nodes.shape}")
    E = elem_nodes.shape[0]
    N = int(elem_nodes.max()) + 1
    n_edges = lib.f2t_count_edges(p_en, E, N)
    if n_edges < 0:
        raise ValueError("non-manifold mesh: an edge borders > 2 triangles")
    edges = np.empty((n_edges, 2), dtype=np.int32)
    edge_tri = np.empty((n_edges, 2), dtype=np.int32)
    if lib.f2t_build_edges(p_en, E, N, _out(edges), _out(edge_tri)) != 0:
        raise ValueError("non-manifold mesh: an edge borders > 2 triangles")
    return edges, edge_tri


def ragged_to_padded(rows, cols, n_rows, extra=None):
    """Native transposed-incidence builder; contract of
    topology._ragged_to_padded."""
    lib = load()
    rows, p_rows = _ptr(rows, np.int32)
    cols, p_cols = _ptr(cols, np.int32)
    n_pairs = len(rows)
    if len(cols) != n_pairs or (extra is not None and len(extra) != n_pairs):
        raise ValueError("rows, cols and extra must have one entry a pair")
    if n_pairs and not 0 <= int(rows.min()) <= int(rows.max()) < n_rows:
        raise ValueError(f"rows must lie in [0, {n_rows})")
    counts = np.empty(n_rows, dtype=np.int32)
    K = max(lib.f2t_ragged_to_padded(p_rows, p_cols, None, n_pairs, n_rows,
                                     0, None, None, _out(counts)), 1)
    padded = np.empty((n_rows, K), dtype=np.int32)
    if extra is None:
        lib.f2t_ragged_to_padded(p_rows, p_cols, None, n_pairs, n_rows, K,
                                 _out(padded), None, _out(counts))
        return padded, counts
    extra32, p_extra = _ptr(extra, np.int32)
    padded_extra = np.empty((n_rows, K), dtype=np.int32)
    lib.f2t_ragged_to_padded(p_rows, p_cols, p_extra, n_pairs, n_rows, K,
                             _out(padded), _out(padded_extra), _out(counts))
    return padded, counts, padded_extra.astype(extra.dtype)


def stress2rhs(elem_nodes, elem_area, ice_strength, sigma11, sigma12,
               sigma22, gradient_sca, metric_factor, inv_areamass, rhs_a,
               rhs_m):
    """The golden reference's EVP stress divergence (``f2t_stress2rhs``,
    reference src/reference.cpp:440-480: the element -> node scatter in
    element order) -> (U [N], V [N]), f64.  Element rows [E],
    ``gradient_sca`` [6, E], node rows [N]."""
    lib = load()
    elem_nodes, p_en = _ptr(elem_nodes, np.int32)
    E = elem_nodes.shape[0]
    N = np.shape(inv_areamass)[0]
    if elem_nodes.shape != (E, 3) or not 0 <= int(elem_nodes.min()) <= \
            int(elem_nodes.max()) < N:
        raise ValueError(f"elem_nodes must be [E, 3] of nodes in [0, {N})")
    shapes = ((E,),) * 5 + ((6, E), (E,)) + ((N,),) * 3
    held = []
    for a, shape in zip((elem_area, ice_strength, sigma11, sigma12, sigma22,
                         gradient_sca, metric_factor, inv_areamass, rhs_a,
                         rhs_m), shapes):
        a = np.ascontiguousarray(a, dtype=np.float64)
        if a.shape != shape:
            raise ValueError(f"stress2rhs input of shape {a.shape}, "
                             f"expected {shape}")
        held.append(a)
    U = np.empty(N)
    V = np.empty(N)
    lib.f2t_stress2rhs(N, E, p_en, *(_out(a) for a in held), _out(U),
                       _out(V))
    return U, V


class NativeReference:
    """C++ golden reference for the FCT-ALE chain (f64, level-major,
    vlimit 1)."""

    def __init__(self, mesh):
        self.lib = load()
        self.mesh = mesh
        self.L = mesh.n_layers
        self.N = mesh.n_nodes
        self.E = mesh.n_elems
        self.Ed = mesh.n_edges
        self._nlev_nod, self.p_nlev_nod = _ptr(mesh.nlev_nod, np.int32)
        self._nlev_elem, self.p_nlev_elem = _ptr(mesh.nlev_elem, np.int32)
        self._nlev_edge, self.p_nlev_edge = _ptr(mesh.nlev_edge, np.int32)
        self._elem_nodes, self.p_elem_nodes = _ptr(mesh.elem_nodes, np.int32)
        self._edges, self.p_edges = _ptr(mesh.edges, np.int32)
        # padding slots hold element 0; node_elems_num bounds the reads
        ne = np.where(mesh.node_elems >= 0, mesh.node_elems, 0)
        self._ne, self.p_ne = _ptr(ne, np.int32)
        self._ne_num, self.p_ne_num = _ptr(mesh.node_elems_num, np.int32)
        self.K = mesh.node_elems.shape[1]
        self._ai, self.p_ai = _ptr(mesh.area_inv[: self.L], np.float64)

    def _p(self, a, shape):
        a = np.ascontiguousarray(a, dtype=np.float64)
        if a.shape != shape:
            raise ValueError(f"field of shape {a.shape}, expected {shape}")
        return a, a.ctypes.data_as(_P)

    def step(self, fields, dt=1.0, flux_eps=1e-16, bignumber=1e3,
             iter_yn=False):
        """Full a->b->c chain (vlimit=1).  Returns dict like the oracle."""
        L, N, E, Ed = self.L, self.N, self.E, self.Ed
        lib = self.lib
        node, vint, edge = (L, N), (L + 1, N), (L, Ed)
        lo, p_lo = self._p(fields["fct_LO"], node)
        ttf, p_ttf = self._p(fields["ttf"], node)
        tmax = np.empty(node)
        tmin = np.empty(node)
        lib.f2t_a1(L, N, self.p_nlev_nod, p_lo, p_ttf, _out(tmax),
                   _out(tmin))
        UV_max = np.empty((L, E))
        UV_min = np.empty((L, E))
        lib.f2t_a2(L, N, E, self.p_elem_nodes, self.p_nlev_elem, _out(tmax),
                   _out(tmin), bignumber, _out(UV_max), _out(UV_min))
        tmax2 = np.empty(node)
        tmin2 = np.empty(node)
        lib.f2t_a3_vlimit1(L, N, E, self.p_nlev_nod, self.p_ne,
                           self.p_ne_num, self.K, _out(UV_max),
                           _out(UV_min), p_lo, _out(tmax2), _out(tmin2))
        adf_v, p_adf_v = self._p(np.array(fields["fct_adf_v"],
                                          dtype=np.float64), vint)
        adf_h, p_adf_h = self._p(np.array(fields["fct_adf_h"],
                                          dtype=np.float64), edge)
        plus = np.empty(node)
        minus = np.empty(node)
        lib.f2t_b1(L, N, Ed, self.p_nlev_nod, self.p_edges, self.p_nlev_edge,
                   p_adf_v, p_adf_h, _out(plus), _out(minus))
        lib.f2t_b2(L, N, self.p_nlev_nod, self.p_ai, _out(tmax2),
                   _out(tmin2), dt, flux_eps, _out(plus), _out(minus))
        adf_v2 = np.zeros_like(adf_v) if iter_yn else None
        lib.f2t_b3_vertical(L, N, self.p_nlev_nod, _out(plus), _out(minus),
                            p_adf_v, int(iter_yn),
                            _out(adf_v2) if iter_yn else None)
        adf_h2 = np.zeros_like(adf_h) if iter_yn else None
        lib.f2t_b3_horizontal(L, N, Ed, self.p_edges, self.p_nlev_edge,
                              _out(plus), _out(minus), p_adf_h, int(iter_yn),
                              _out(adf_h2) if iter_yn else None)
        out = dict(fct_ttf_max=tmax2, fct_ttf_min=tmin2, fct_plus=plus,
                   fct_minus=minus)
        hn, p_hn = self._p(fields["hnode_new"], node)
        if iter_yn:
            new_LO, p_new_LO = self._p(np.array(fields["fct_LO"],
                                                dtype=np.float64), node)
            lib.f2t_c_update_LO(L, N, Ed, self.p_nlev_nod, self.p_edges,
                                self.p_nlev_edge, p_adf_v, p_adf_h,
                                self.p_ai, p_hn, dt, p_new_LO)
            out.update(fct_LO=new_LO, fct_adf_v=adf_v2, fct_adf_h=adf_h2,
                       fct_adf_v_limited=adf_v, fct_adf_h_limited=adf_h)
        else:
            del_v, p_del_v = self._p(np.array(fields["del_ttf_advvert"],
                                              dtype=np.float64), node)
            del_h, p_del_h = self._p(np.array(fields["del_ttf_advhoriz"],
                                              dtype=np.float64), node)
            hnode, p_hnode = self._p(fields["hnode"], node)
            lib.f2t_c_update_solution(L, N, Ed, self.p_nlev_nod, self.p_edges,
                                      self.p_nlev_edge, p_ttf, p_hnode, p_hn,
                                      p_lo, p_adf_v, p_adf_h, self.p_ai, dt,
                                      p_del_v, p_del_h)
            out.update(fct_adf_v=adf_v, fct_adf_h=adf_h,
                       del_ttf_advvert=del_v, del_ttf_advhoriz=del_h)
        return out
