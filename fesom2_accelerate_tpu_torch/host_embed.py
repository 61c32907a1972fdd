"""Host-embedding surface: the Python side of the port's C ABI.

The counterpart of ``fesom2_accelerate_tpu/host_embed.py``.  The
reference's L1 is a Fortran-callable C ABI that mirrors host arrays into
GPU memory and drives the production pipeline (reference
include/fesom2-accelerate.h:128-236, src/fesom2-accelerate.cu:258-379).
Here it is split in two:

* ``native/fesom2_torch_host.cpp``: the ``extern "C"`` surface a Fortran
  or C host links against (``f2t_init_``, ``f2t_setup_``, ``f2t_dims_``,
  ``f2t_fct_ale_step_``, ``f2t_finalize_``), with the parameter lists of
  the JAX package's ``native/fesom2_tpu_host.cpp``, so a host links either
  library unchanged, and a rank's partition in two phases around the
  host's exchange (``f2t_setup_part_``, ``f2t_fct_ale_pre_comm_``,
  ``f2t_fct_ale_post_comm_``).  It embeds CPython and calls this module;
* this module: it wraps the caller's host pointers as numpy views
  (zero-copy), builds the mesh (``mesh/topology.py``
  ``build_mesh_from_elements``) and the solver once at :func:`setup` (the
  reference's one-time ``transfer_mesh_``), and each :func:`step` copies
  the input fields to the solver's device, runs one step and writes the
  results back into the caller's buffers (the reference's
  ``transfer_var_`` and its read-backs).

Backends:

* 0: the plain PyTorch step (``ops/stages.py``, ``backend="torch"``) in
  float64 on the card, the correctness path, as the reference ships
  ``src/reference.cpp`` and the JAX shim's backend 0 runs XLA's plain f64
  stages on the chip.  It launches none of the port's kernels, so it stays
  independent of backends 1 and 2.  It runs on the CPU only where the
  caller asks for it: ``FESOM2_TORCH_DEVICE=cpu`` in the environment (read
  at :func:`setup`), in the role ``JAX_PLATFORMS=cpu`` plays for the JAX
  shim, since the ABI passes only integers;
* 1: the CUDA kernels in float32 (``flux_eps=1e-7``) on the card;
* 2: the CUDA kernels in float64 (``flux_eps=1e-16``) on the card: FESOM2's
  own working precision (``WP = 8``), as the reference library builds its
  kernels on ``real_type = double`` (include/fesom2-accelerate.h:10).

Any backend on a host with no card, and backend 1 or 2 asked for the CPU,
make :func:`setup` say why and return 1; nothing falls back to the CPU and
nothing stands in for the kernels.  Unset or ``cuda``, the variable means
the card (the current device, which ``parallel/distributed.py``
``bind_device`` sets for a rank); any other value fails :func:`setup`.

Every function takes only ints (sizes, flags) and addresses (pointer
values), so the C side needs nothing beyond ``PyObject_CallObject`` with
integer arguments.  Connectivity is 0-based, as in the JAX shim.  The
embedding holds one solver a process, as the ABI passes no handle.

Copies.  Every call copies each input buffer to the solver's device in
f64 and casts it there to the config's dtype (bit for bit the host's
round-to-nearest cast), casts each result to f64 there and copies it
straight into the caller's buffer, and, on the card, waits for its copies
before it returns.  Where the config's dtype is f64 (backends 0 and 2) no
cast happens: the copy the DMA lands in is the solver's state, and a
result goes back from the tensor the phase wrote (:func:`_cast`).  Nothing
is skipped or kept on the device between calls: every call moves every
buffer.  Every entry point runs the solver's
three phases (``FctAleSolver.pre_comm``, ``inter_comm``, ``post_comm``;
every column owned, a whole step's bits) under one copy plan
(:data:`INPUTS`, :data:`RESULTS`): each input by the phase that first reads
it, each result by the phase after which it is final.  :func:`copy_in`
enqueues every input's DMA in plan order, each followed by an event;
each phase casts the inputs it reads first, after their events;
:func:`copy_out` writes each result back behind its phase's event, then
waits.  Where that work goes is chosen once a call (:func:`_begin`): on
the card a :func:`step` takes three streams ("lanes"), the inputs' copies
on a copy stream, the phases on the current stream, the write-back on a
third, so the fluxes K2 and K3 finalise go out over PCIe while the inputs
that only stage c reads still come in; a rank's :func:`pre_comm` and
:func:`post_comm` put every copy on the current stream; on the CPU there
are no streams and each copy runs in plan order, in turn.  On the card the
first call that sees a buffer page-locks its bytes (``cudaHostRegister``,
default flags) and the session keeps them locked, by address and byte
count, from then on (:class:`Pins`), so the copies are DMA of the caller's
own memory.  CUDA locks a page that two buffers share for each of them.  A
buffer CUDA will not lock (the caller locked it already, or the driver
refuses) takes the same copies on the same lanes, which CUDA then stages
through pageable memory; a solver on the CPU locks nothing.

**The ABI contract**: a buffer passed to a step stays page-locked from its
first step until :func:`reset` (``f2t_finalize_``), which unregisters every
buffer the session registered, and must not be freed before.  Nothing
detects a buffer freed early: CUDA keeps its old pages locked, and a new
buffer at the same address and size is taken for the locked one, so the
step reads stale inputs from the old pages and writes its results there,
not into the new buffer, with no error.  A buffer at a registered address
with another byte count is registered anew.  So a host allocates its ABI
buffers once and passes the same arrays every step, never a temporary
(``transpose(x)``, a non-contiguous section): FESOM2's own fields are
level-fastest ``(nl-1, node)``, the ABI's level-major ``[L, N]``, so a
FESOM2 host keeps ABI buffers of its own, allocated at set-up beside the
fields, as FESOM2 allocates the tracers and ``del_ttf_adv*``
(``oce_setup_step.F90``), ``fct_LO`` and the antidiffusive fluxes
(``oce_adv_tra_fct.F90``) and ``hnode`` / ``hnode_new`` (``oce_ale.F90``)
once for the run.

**A rank's partition** (the deployment the reference's three phases
exist for, src/fesom2-accelerate.cu:258,342,358).  :func:`setup_part`
takes the rank's local mesh in FESOM2's local numbering, owned nodes
first, and a step is one :func:`pre_comm`, the host's own
``exchange_nod(fct_plus, fct_minus)``, and one :func:`post_comm`, per
tracer.  :func:`pre_comm` writes both factors, every column, into two f64
buffers of the host's; the host overwrites their halo columns with their
owners' values; :func:`post_comm` reads only those halo columns back and
writes the step's results as :func:`step` does.  The two phases take the
same ten buffers, under the same contract as a step's eight: the factor
buffers too stay page-locked from their first phase until :func:`reset`.
Owned results are right only where every element that touches an owned
node is in the local mesh and the exchange filled every halo column; in
iterative mode the host refreshes ``fct_LO``'s halo after a step, as the
sharded step does.  With no halo (``n_owned`` every node, or a session of
:func:`setup`) the phases give :func:`step`'s bits.

Under a profiler a :func:`step` is the span ``abi.step``, with
``abi.copy_in`` (the inputs' DMA enqueued), ``solver.pre_comm``,
``solver.inter_comm``, ``solver.post_comm`` and ``abi.copy_out`` (the
results' casts and DMA enqueued, and the wait for every lane of the call,
which also waits for copy-in's DMA) under it (``runtime/tracing.py``).  A
:func:`pre_comm` is the span ``abi.pre_comm`` (``abi.copy_in``,
``solver.pre_comm``, ``abi.factors_out``, ``solver.inter_comm``, then the
wait for the factors), a :func:`post_comm` ``abi.post_comm``
(``abi.factors_in``, ``solver.post_comm``, ``abi.copy_out``).  The
counters ``abi.bytes_registered`` and ``abi.bytes_pageable`` add up the
bytes of the caller's buffers that moved from and to page-locked memory
and from and to any other, ``abi.bytes_out`` those of the results written
back and ``abi.bytes_out_early`` the part of them copied on the
write-back stream behind K2's or K3's end rather than stage c's;
``abi.bytes_cast`` the f64 bytes cast on the device between the caller's
f64 and the solver's dtype, both ways: every byte of the ABI's traffic
under backend 1, none under backends 0 and 2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import sys
import traceback
from typing import NamedTuple

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh.topology import (
    Mesh,
    build_mesh_from_elements,
)
from fesom2_accelerate_tpu_torch.model.fct_ale import FctAleSolver
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.runtime import tracing

__all__ = ["setup", "setup_part", "dims", "step", "pre_comm", "post_comm",
           "reset"]

# the environment variable by which a caller asks for the CPU (backend 0)
DEVICE_ENV = "FESOM2_TORCH_DEVICE"
# each backend's dtype and limiter guard ``flux_eps``: 0 the plain stages,
# 1 and 2 the CUDA kernels (module docstring)
BACKENDS = {0: (torch.float64, 1e-16), 1: (torch.float32, 1e-7),
            2: (torch.float64, 1e-16)}
# the limiter factors a rank's host exchanges between pre_comm and post_comm
FACTORS = ("fct_plus", "fct_minus")
# The copy plan of a step.  Each of the eight input buffers by the phase of
# the split step (FctAleSolver.pre_comm, inter_comm, post_comm) that first
# reads it, in the order a step copies them in: what K1 reads, what K2
# reads, then what only stage c reads.
INPUTS = (("ttf", "pre_comm"), ("fct_LO", "pre_comm"),
          ("fct_adf_v", "pre_comm"), ("fct_adf_h", "pre_comm"),
          ("hnode", "post_comm"), ("hnode_new", "post_comm"),
          ("del_ttf_advvert", "post_comm"), ("del_ttf_advhoriz", "post_comm"))
# Each result by the phase after which it is final, by the solver's backend
# and iter_yn, in the order a call writes them back.  "cuda": the limited
# (iterative: residual) vertical flux after K2, the horizontal one after K3
# (K4-fix rewrites only the edges with an endpoint outside the owned
# columns, and a step owns every column), stage c's fields after K4-fix.  A
# result final before post_comm is early.
RESULTS = {"cuda": {
    False: (("fct_adf_v", "pre_comm"), ("fct_adf_h", "inter_comm"),
            ("del_ttf_advvert", "post_comm"),
            ("del_ttf_advhoriz", "post_comm")),
    True: (("fct_adf_v", "pre_comm"), ("fct_adf_h", "inter_comm"),
           ("fct_LO", "post_comm")),
}}
# "torch" (backend 0's plain stages) runs no K2 or K3, and its b3 ends in
# inter_comm and post_comm: each result is taken after post_comm
RESULTS["torch"] = {it: tuple((k, "post_comm") for k, _ in plan)
                    for it, plan in RESULTS["cuda"].items()}


class Pins:
    """The caller's buffers that a session page-locked: byte count by
    address, and those whose registration failed, which are not tried
    again at that size."""

    def __init__(self, device: torch.device):
        self.device = device
        self.held: dict = {}
        self.refused: dict = {}

    def pinned(self, a: np.ndarray) -> bool:
        """Whether ``a``'s bytes are page-locked, registering them at their
        first sight."""
        addr, n = a.ctypes.data, a.nbytes
        if self.held.get(addr) == n:
            return True
        if self.refused.get(addr) == n:
            return False
        if addr in self.held:
            self._unregister(addr)
            del self.held[addr]
        self.refused.pop(addr, None)
        if int(_cudart().cudaHostRegister(addr, n, 0)) == 0:
            self.held[addr] = n
            return True
        _clear_error(self.device)
        self.refused[addr] = n
        return False

    def _unregister(self, addr: int) -> None:
        if int(_cudart().cudaHostUnregister(addr)) != 0:
            _clear_error(self.device)

    def release(self) -> None:
        """Unregisters every buffer the session registered."""
        for addr in self.held:
            self._unregister(addr)
        self.held.clear()
        self.refused.clear()


def _cudart():
    return torch.cuda.cudart()


def _clear_error(device: torch.device) -> None:
    """Clears the CUDA runtime's last error, which a refused registration
    leaves set and the next kernel launch's check would raise:
    ``torch.cuda.cudart()`` binds no ``cudaGetLastError``, so a launch's
    check reads it, and resets it."""
    try:
        torch.zeros(1, device=device)
    except RuntimeError:
        pass


def _pinnable(device: torch.device) -> bool:
    """Whether a solver on ``device`` page-locks the caller's buffers: on
    the card, not on the CPU."""
    return device.type == "cuda"


class Pending(NamedTuple):
    """What a :func:`pre_comm` leaves on the device for the
    :func:`post_comm` after it: the ten buffers' addresses, the eight
    fields' views, the inputs copied in and not yet cast (``staged``), the
    state cast so far, the factors (``pre``) and the work enqueued while
    the host exchanges (``inter``)."""

    addrs: tuple
    host: dict
    staged: dict
    state: dict
    pre: dict
    inter: object


class Lanes(NamedTuple):
    """The streams of one call: the solver's phases (``compute``, the
    current stream), the inputs' copies and the results' write-back.
    ``copy`` or ``back`` None: that work goes on the compute stream, in
    order; every lane None: the CPU, where each copy is done in turn."""

    compute: object
    copy: object
    back: object


@dataclasses.dataclass
class Session:
    """What :func:`setup` or :func:`setup_part` built: the mesh (a rank's
    local mesh, owned columns first), the config, the solver, the buffers
    it page-locked (None on the CPU), the number of owned columns (every
    column after :func:`setup`), what a :func:`pre_comm` left for its
    :func:`post_comm`, a step's copy and write-back streams, made at its
    first call on the card, and the current call's lanes, the buffers
    page-locked among its own (address, byte count) and the events after
    which each phase's results are final (:func:`_begin`)."""

    mesh: Mesh
    cfg: FctAleConfig
    solver: FctAleSolver
    pins: Pins | None
    n_owned: int
    pending: Pending | None = None
    streams: tuple | None = None
    lanes: Lanes = Lanes(None, None, None)
    locked: frozenset = frozenset()
    done: dict = dataclasses.field(default_factory=dict)


_SESSION: Session | None = None


class NoDevice(RuntimeError):
    """A backend on a host with no CUDA device, or backend 1 or 2 asked for
    the CPU."""


class BadDevice(ValueError):
    """A value of ``FESOM2_TORCH_DEVICE`` other than ``cuda`` or ``cpu``."""


def _view(addr: int, shape, dtype) -> np.ndarray:
    """Zero-copy numpy view of caller-owned host memory."""
    n = int(np.prod(shape))
    ctype = {"float64": ctypes.c_double, "int32": ctypes.c_int32}[
        np.dtype(dtype).name]
    buf = (ctype * n).from_address(int(addr))
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def config(backend: int, dt_milli: int, vlimit: int,
           iter_yn: int) -> FctAleConfig:
    """The config of ``backend`` (:data:`BACKENDS`).  ``dt_milli`` is the
    timestep in 1e-3 units (the ABI passes integers only)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be 0 (torch f64 on the card, or on "
                         f"the CPU with {DEVICE_ENV}=cpu), 1 (CUDA kernels "
                         f"f32) or 2 (CUDA kernels f64), got {backend}")
    dtype, flux_eps = BACKENDS[backend]
    return FctAleConfig(dt=dt_milli * 1e-3, vlimit=vlimit,
                        iter_yn=bool(iter_yn), dtype=dtype, flux_eps=flux_eps)


def _device(backend: int) -> torch.device:
    """The device of ``backend``'s solver: the card (the current CUDA
    device), or the CPU where ``FESOM2_TORCH_DEVICE=cpu`` asks for it and
    the backend is 0.  Raises NoDevice or BadDevice."""
    asked = os.environ.get(DEVICE_ENV, "cuda")
    if asked not in ("cuda", "cpu"):
        raise BadDevice(f"{DEVICE_ENV}={asked!r}: unset or 'cuda' runs on "
                        f"the card, 'cpu' runs backend 0 on the CPU")
    if asked == "cpu":
        if backend != 0:
            raise NoDevice(f"backend {backend} runs the CUDA kernels and "
                           f"needs a CUDA device: {DEVICE_ENV}=cpu asks for "
                           f"the CPU")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        what = ("runs the CUDA kernels" if backend != 0 else
                f"runs the plain f64 step on the card (or on the CPU with "
                f"{DEVICE_ENV}=cpu)")
        raise NoDevice(f"backend {backend} {what} and needs a CUDA device: "
                       f"torch.cuda.is_available() is False")
    return torch.device("cuda")


def _solver(mesh: Mesh, cfg: FctAleConfig, backend: int) -> FctAleSolver:
    # backend 0 is the plain stages wherever it runs, as the JAX shim's
    # backend 0 is XLA's; backends 1 and 2 the kernels
    return FctAleSolver(mesh, cfg, "torch" if backend == 0 else "cuda",
                        device=_device(backend))


def part_mesh(mesh: Mesh, n_owned: int) -> Mesh:
    """``mesh`` as one part of a split step: columns [0, n_owned) the owned
    nodes, every later one a halo node whose node->element and node->edge
    rows are emptied, as ``parallel/partition.py`` leaves a part's halo
    rows.  A halo node's rows on a rank are incomplete: its factors come
    from the host's exchange, and H-K4's FIX form needs every row inside
    the owned columns (``kernels.update_fixup``).  A mesh with no halo is
    returned as it is."""
    if not 1 <= n_owned <= mesh.n_nodes:
        raise ValueError(f"n_owned={n_owned}: a rank owns 1 to n_nodes="
                         f"{mesh.n_nodes} nodes, numbered first")
    if n_owned == mesh.n_nodes:
        return mesh
    rows = {}
    for name, empty in (("node_elems", -1), ("node_elems_pos", -1),
                        ("node_elems_num", 0), ("node_edges", -1),
                        ("node_edges_sign", -1), ("node_edges_num", 0)):
        a = getattr(mesh, name).copy()
        a[n_owned:] = empty
        rows[name] = a
    return dataclasses.replace(mesh, **rows)


def _setup(n_elems: int, nl: int, elem_nodes_addr: int, nlev_elem_addr: int,
           n_nodes: int, n_owned: int | None, node_xy_addr: int,
           dt_milli: int, vlimit: int, iter_yn: int, backend: int) -> int:
    global _SESSION
    try:
        elem_nodes = _view(elem_nodes_addr, (n_elems, 3), np.int32).copy()
        nlev_elem = _view(nlev_elem_addr, (n_elems,), np.int32).copy()
        node_xy = _view(node_xy_addr, (n_nodes, 2), np.float64).copy()
        mesh = build_mesh_from_elements(elem_nodes, nlev_elem, nl, node_xy)
        mesh.validate()
        if n_owned is None:
            n_owned = mesh.n_nodes
        mesh = part_mesh(mesh, n_owned)
        cfg = config(backend, dt_milli, vlimit, iter_yn)
        solver = _solver(mesh, cfg, backend)
        pins = Pins(solver.device) if _pinnable(solver.device) else None
        reset()
        _SESSION = Session(mesh, cfg, solver, pins, n_owned)
        return 0
    except (NoDevice, BadDevice) as e:
        print(f"fesom2_accelerate_tpu_torch.host_embed.setup: {e}",
              file=sys.stderr, flush=True)
        return 1
    except Exception:  # the ABI's boundary: report, return istat 1
        traceback.print_exc()
        return 1


def setup(n_elems: int, nl: int, elem_nodes_addr: int, nlev_elem_addr: int,
          n_nodes: int, node_xy_addr: int, dt_milli: int, vlimit: int,
          iter_yn: int, backend: int) -> int:
    """Builds the mesh and the solver from host connectivity (once, as the
    reference's ``transfer_mesh_`` and ``alloc_var_``): ``elem_nodes``
    [n_elems, 3] int32, 0-based; ``nlev_elem`` [n_elems] int32;
    ``node_xy`` [n_nodes, 2] float64.  Returns 0 on success, 1 on failure
    (the reference's ``istat``, src/fesom2-accelerate.cu:114-127)."""
    return _setup(n_elems, nl, elem_nodes_addr, nlev_elem_addr, n_nodes,
                  None, node_xy_addr, dt_milli, vlimit, iter_yn, backend)


def setup_part(n_elems: int, nl: int, elem_nodes_addr: int,
               nlev_elem_addr: int, n_nodes: int, n_owned: int,
               node_xy_addr: int, dt_milli: int, vlimit: int, iter_yn: int,
               backend: int) -> int:
    """:func:`setup` on one rank's partition, in FESOM2's local numbering:
    its ``n_owned`` owned nodes (``myDim_nod2D``) first, then its halo
    nodes (``eDim_nod2D``), ``n_nodes`` in all; every element that touches
    an owned node, in any order, with local node ids.  The halo nodes'
    incidence rows are emptied (:func:`part_mesh`): the split step's
    layout, so no column is permuted.  :func:`dims` then gives the local
    counts.  The edges are derived from the local elements, each running
    from its lower local id, sorted by it: the order of the host's edge
    buffers, whose fluxes are signed by those directions (a host negates
    the flux of an edge that runs the other way in its own numbering, in
    and out).  A step is :func:`pre_comm`, the host's exchange of the
    factors' halo columns, :func:`post_comm`; :func:`step` refuses a
    session with a halo.  Returns 0 or 1, as :func:`setup`."""
    return _setup(n_elems, nl, elem_nodes_addr, nlev_elem_addr, n_nodes,
                  n_owned, node_xy_addr, dt_milli, vlimit, iter_yn, backend)


def session() -> Session:
    if _SESSION is None:
        raise RuntimeError("host_embed: setup has not succeeded")
    return _SESSION


def dims() -> tuple:
    """(n_nodes, n_edges, n_layers): the edge count is derived here (the
    host sizes its flux buffers from it)."""
    mesh = session().mesh
    return (int(mesh.n_nodes), int(mesh.n_edges), int(mesh.n_layers))


def views(ttf_a: int, lo_a: int, adf_v_a: int, adf_h_a: int, hnode_a: int,
          hnode_new_a: int, del_v_a: int, del_h_a: int) -> dict:
    """The caller's eight f64 buffers as zero-copy numpy views, by field
    name: level-major [L, N] node fields, [L+1, N] interface fluxes,
    [L, Ed] edge fluxes."""
    mesh = session().mesh
    L, N, Ed = mesh.n_layers, mesh.n_nodes, mesh.n_edges
    return dict(
        ttf=_view(ttf_a, (L, N), np.float64),
        fct_LO=_view(lo_a, (L, N), np.float64),
        fct_adf_v=_view(adf_v_a, (L + 1, N), np.float64),
        fct_adf_h=_view(adf_h_a, (L, Ed), np.float64),
        hnode=_view(hnode_a, (L, N), np.float64),
        hnode_new=_view(hnode_new_a, (L, N), np.float64),
        del_ttf_advvert=_view(del_v_a, (L, N), np.float64),
        del_ttf_advhoriz=_view(del_h_a, (L, N), np.float64),
    )


def factor_views(plus_a: int, minus_a: int) -> dict:
    """The caller's two f64 factor buffers, [L, N] each, as zero-copy
    numpy views by name (``FACTORS``)."""
    mesh = session().mesh
    shape = (mesh.n_layers, mesh.n_nodes)
    return dict(zip(FACTORS, (_view(plus_a, shape, np.float64),
                              _view(minus_a, shape, np.float64))))


def _begin(s: Session, buffers, side: bool) -> None:
    """Chooses a call's lanes once, from what the session sees, and
    page-locks the call's ``buffers`` at their first sight (the one caller
    of :meth:`Pins.pinned`; ``s.locked`` keeps what it found).  On the CPU
    there are no streams.  On the card the phases go on the current
    stream, and the copies, where ``side`` (a :func:`step`), on the
    session's copy and write-back streams, else (a rank's phases) on the
    current stream too.  A buffer CUDA would not lock takes the same
    lanes."""
    s.done = {}
    if s.pins is None:
        s.lanes, s.locked = Lanes(None, None, None), frozenset()
        return
    s.locked = frozenset((a.ctypes.data, a.nbytes) for a in buffers
                         if s.pins.pinned(a))
    compute = torch.cuda.current_stream(s.solver.device)
    if not side:
        s.lanes = Lanes(compute, None, None)
        return
    if s.streams is None:
        s.streams = (torch.cuda.Stream(s.solver.device),
                     torch.cuda.Stream(s.solver.device))
    s.lanes = Lanes(compute, *s.streams)


def _event(stream):
    """An event recorded on ``stream``; None where there is no stream."""
    if stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _wait(s: Session | None) -> None:
    """Waits for every stream of the call's lanes (none on the CPU), so
    that no copy of the call touches a caller's buffer after it."""
    for stream in s.lanes if s is not None else ():
        if stream is not None:
            stream.synchronize()


def _counted(a: np.ndarray) -> None:
    """Adds ``a``'s bytes to the counter of the path :func:`_begin` found
    they take."""
    locked = (a.ctypes.data, a.nbytes) in session().locked
    tracing.count("abi.bytes_registered" if locked else "abi.bytes_pageable",
                  a.nbytes)


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` cast to ``dtype`` on its device, counting its f64 bytes under
    ``abi.bytes_cast``; ``t`` itself, and nothing counted, where it is in
    ``dtype`` already."""
    if t.dtype == dtype:
        return t
    tracing.count("abi.bytes_cast", t.numel() * 8)
    return t.to(dtype)


@tracing.spanned("abi.copy_in")
def copy_in(host: dict) -> dict:
    """Copies the fields of :func:`views` to the solver's device in f64,
    in plan order (:data:`INPUTS`): on the card enqueued on the call's
    copy lane behind what the compute lane holds (DMA of the buffer once
    it is page-locked), each followed by an event where that lane is a
    stream of its own -> {field: (the f64 copy, its event or None)}.  The
    phase that first reads a field casts it (:func:`_phase`)."""
    s = session()
    lanes = s.lanes
    if lanes.copy is not None:
        lanes.copy.wait_stream(lanes.compute)
    staged = {}
    with torch.cuda.stream(lanes.copy):
        for k, _ in INPUTS:
            _counted(host[k])
            # copy=True: on any device the state never aliases the buffer
            t = torch.from_numpy(host[k]).to(s.solver.device,
                                              non_blocking=True, copy=True)
            if lanes.copy is not None:
                t.record_stream(lanes.compute)
            staged[k] = (t, _event(lanes.copy))
    return staged


def _phase(s: Session, staged: dict, state: dict, name: str, *args):
    """The solver's phase ``name`` (``pre_comm``, ``inter_comm``,
    ``post_comm``) on the compute lane, on ``state`` and ``args``: first
    the inputs it reads first (:data:`INPUTS`) taken from ``staged`` and
    cast to the config's dtype (:func:`_cast`: in f64 the copy itself),
    each after its copy's event; then, where the results go back on a
    stream of their own, the event after which the phase's are final
    (``s.done``)."""
    for k, first in INPUTS:
        if first == name:
            t, ready = staged.pop(k)
            if ready is not None:
                s.lanes.compute.wait_event(ready)
            state[k] = _cast(t, s.cfg.dtype)
    result = getattr(s.solver, name)(state, *args)
    if s.lanes.back is not None:
        s.done[name] = _event(s.lanes.compute)
    return result


@tracing.spanned("abi.copy_out")
def copy_out(out: dict, host: dict) -> None:
    """Writes a call's results into the caller's buffers: the limited
    fluxes over ``fct_adf_v`` / ``fct_adf_h``; ``fct_LO`` in iterative
    mode, else ``del_ttf_advvert`` / ``del_ttf_advhoriz``.  Each result in
    plan order (:data:`RESULTS`), cast to f64 on its device and copied into
    the buffer (DMA once it is page-locked), on the call's write-back lane,
    where that is a stream of its own behind the event of the phase after
    which the result is final.  Every buffer is whole when it returns."""
    s = session()
    back = s.lanes.back
    with torch.cuda.stream(back):
        for k, phase in RESULTS[s.solver.backend][s.cfg.iter_yn]:
            t = out[k]
            if back is not None:
                back.wait_event(s.done[phase])
                t.record_stream(back)
            _counted(host[k])
            tracing.count("abi.bytes_out", host[k].nbytes)
            if back is not None and phase != "post_comm":
                tracing.count("abi.bytes_out_early", host[k].nbytes)
            torch.from_numpy(host[k]).copy_(_cast(t, torch.float64),
                                            non_blocking=True)
    _wait(s)


def _istat(fn):
    """The ABI's boundary around an entry point: 0 once ``fn`` returns;
    where it raises, the wait for the call's lanes (no copy in flight
    touches a buffer after the call), the traceback, and 1."""
    @functools.wraps(fn)
    def call(*args) -> int:
        try:
            try:
                fn(*args)
            except BaseException:
                _wait(_SESSION)
                raise
        except Exception:  # report, return istat 1
            traceback.print_exc()
            return 1
        return 0
    return call


@tracing.spanned("abi.step")
@_istat
def step(ttf_a: int, lo_a: int, adf_v_a: int, adf_h_a: int, hnode_a: int,
         hnode_new_a: int, del_v_a: int, del_h_a: int) -> None:
    """One FCT-ALE step on host-owned f64 buffers.

    In/out (the read-backs of the reference's phase entry points,
    src/fesom2-accelerate.cu:338-378, plus the stage-c outputs its L2 never
    wired): ``fct_adf_v`` / ``fct_adf_h`` are overwritten with the limited
    fluxes; non-iterative mode accumulates into ``del_v`` / ``del_h``;
    iterative mode overwrites ``fct_LO`` and leaves the residual fluxes in
    ``fct_adf_v`` / ``fct_adf_h``.  The solver's three phases with every
    column owned, which give :meth:`FctAleSolver.step`'s bits, under the
    copy plan, on the card on three streams (module docstring); every
    buffer is whole when it returns.  Returns 0, or 1 on failure."""
    s = session()
    if s.n_owned < s.mesh.n_nodes:
        raise ValueError(
            f"a partition with {s.mesh.n_nodes - s.n_owned} halo nodes "
            f"steps as pre_comm, the host's exchange of the factors' "
            f"halo columns, post_comm: a whole step would limit the "
            f"edges next to the halo on factors no exchange filled")
    host = views(ttf_a, lo_a, adf_v_a, adf_h_a, hnode_a, hnode_new_a,
                 del_v_a, del_h_a)
    _begin(s, host.values(), side=True)
    staged, state = copy_in(host), {}
    pre = _phase(s, staged, state, "pre_comm")
    inter = _phase(s, staged, state, "inter_comm", pre)
    copy_out(_phase(s, staged, state, "post_comm", pre, inter,
                    (0, s.n_owned)), host)


@tracing.spanned("abi.factors_out")
def factors_out(pair: torch.Tensor, factors: dict):
    """Copies the limiter factors ``pair`` ([2, L, N]) into the caller's
    two buffers, every column: cast to f64 on the device, each copied
    into its buffer (DMA once it is page-locked), enqueued on the current
    stream.  Returns an event behind the copies on the card, None on the
    CPU, where they are done."""
    s = session()
    both = _cast(pair, torch.float64)
    for k, v in zip(FACTORS, both):
        _counted(factors[k])
        torch.from_numpy(factors[k]).copy_(v, non_blocking=True)
    return _event(s.lanes.compute)


@tracing.spanned("abi.factors_in")
def factors_in(pair: torch.Tensor, factors: dict) -> None:
    """Writes the halo columns [n_owned, N) of the caller's two factor
    buffers, which the host's exchange filled, into ``pair`` in place:
    each buffer's halo block gathered on the host (pageable), copied to
    the device in f64 and cast there.  The owned columns keep
    :func:`pre_comm`'s values: nothing reads the caller's."""
    s = session()
    if s.n_owned == s.mesh.n_nodes:
        return
    for half, k in zip(pair, FACTORS):
        halo = factors[k][:, s.n_owned:]
        tracing.count("abi.bytes_pageable", halo.nbytes)
        half[:, s.n_owned:] = _cast(torch.from_numpy(halo).to(
            s.solver.device, non_blocking=True, copy=True), s.cfg.dtype)


@tracing.spanned("abi.pre_comm")
@_istat
def pre_comm(ttf_a: int, lo_a: int, adf_v_a: int, adf_h_a: int,
             hnode_a: int, hnode_new_a: int, del_v_a: int, del_h_a: int,
             plus_a: int, minus_a: int) -> None:
    """A rank's step up to its host's exchange (the reference's
    ``fct_ale_pre_comm_acc_``) on the eight f64 buffers of :func:`step`
    and two f64 factor buffers ``fct_plus``, ``fct_minus`` [L, N]: the
    eight copied in (:func:`copy_in`), K1, K2 (backends 1, 2) or the plain
    stages a1..b2 (backend 0), the factors of every column written into
    the two buffers (:func:`factors_out`), then the work that reads no
    exchanged value enqueued (K3, or b3 vertical), which the card does
    while the host exchanges; every copy on the current stream.  Returns
    once the factors are in the buffers: 0, or 1 on failure, also where a
    pre_comm still awaits its post_comm.  The rest of the step stays on
    the device for :func:`post_comm`."""
    s = session()
    if s.pending is not None:
        raise RuntimeError("pre_comm: the pre_comm before it awaits "
                           "its post_comm")
    addrs = (ttf_a, lo_a, adf_v_a, adf_h_a, hnode_a, hnode_new_a,
             del_v_a, del_h_a, plus_a, minus_a)
    host, factors = views(*addrs[:8]), factor_views(plus_a, minus_a)
    _begin(s, [*host.values(), *factors.values()], side=False)
    staged, state = copy_in(host), {}
    pre = _phase(s, staged, state, "pre_comm")
    done = factors_out(kernels.factor_pair(pre["fct_plus"],
                                           pre["fct_minus"]), factors)
    inter = _phase(s, staged, state, "inter_comm", pre)
    if done is not None:
        done.synchronize()
    s.pending = Pending(addrs, host, staged, state, pre, inter)


@tracing.spanned("abi.post_comm")
@_istat
def post_comm(ttf_a: int, lo_a: int, adf_v_a: int, adf_h_a: int,
              hnode_a: int, hnode_new_a: int, del_v_a: int, del_h_a: int,
              plus_a: int, minus_a: int) -> None:
    """The rest of the step after the host's exchange (the reference's
    ``fct_ale_post_comm_acc_``), on the ten buffers of the
    :func:`pre_comm` before it: the factors' halo columns copied in
    (:func:`factors_in`), the inputs only stage c reads cast, K4-fix on
    the owned columns (backends 1, 2) or the plain b3 and stage c (backend
    0), and the results written into the caller's buffers as :func:`step`
    writes them (:func:`copy_out`), every copy on the current stream.
    Returns 0, or 1 on failure (no pre_comm before it, or other
    buffers)."""
    s = session()
    pending, s.pending = s.pending, None
    if pending is None:
        raise RuntimeError("post_comm: no pre_comm before it")
    addrs = (ttf_a, lo_a, adf_v_a, adf_h_a, hnode_a, hnode_new_a,
             del_v_a, del_h_a, plus_a, minus_a)
    if addrs != pending.addrs:
        raise ValueError("post_comm takes the ten buffers of the "
                         "pre_comm before it")
    _begin(s, pending.host.values(), side=False)
    pre = pending.pre
    factors_in(kernels.factor_pair(pre["fct_plus"], pre["fct_minus"]),
               factor_views(plus_a, minus_a))
    copy_out(_phase(s, pending.staged, pending.state, "post_comm", pre,
                    pending.inter, (0, s.n_owned)), pending.host)


def reset() -> int:
    """Ends the session: unregisters every buffer it page-locked."""
    global _SESSION
    if _SESSION is not None and _SESSION.pins is not None:
        _SESSION.pins.release()
    _SESSION = None
    return 0
