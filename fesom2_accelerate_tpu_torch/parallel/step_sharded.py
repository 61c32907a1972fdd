"""Domain-decomposed FCT-ALE step: P parts in one process (PyTorch port).

Counterpart of ``fesom2_accelerate_tpu/parallel/step_sharded.py``.  The
mesh is split by :func:`~fesom2_accelerate_tpu_torch.parallel.partition.
partition_mesh` into P parts in the [H | owned | H] local layout; part p
lives on ``devices[p]`` (several parts may share one card, as the JAX tests
run 8 virtual CPU devices).  The step keeps the reference's three phases
(src/fesom2-accelerate.cu:258,342,358) around the host MPI ``exchange_nod``
of ``fct_plus``/``fct_minus`` (docs/refactoring.md:199-200,235), which
becomes a halo fill over the list of per-part tensors.  Where the JAX
package calls the exchange inside ``shard_map`` from each part's step, a
single-process step enqueues every part's pre-exchange phase first, then
the one exchange, then every part's post-exchange phase.

Two backends:

* ``cuda``: :func:`sharded_fct_ale_step_cuda`, the CUDA kernels per part
  (``ops/cuda/step.py``), in one of two modes:

  - split (the default): K1, K2 and K3 (every edge limited on the
    pre-exchange factors) on every part, the exchange, then K3fix (only
    the edges that touch a halo node, with the exchanged factors) and K4;
  - fused: K1 and K2 on every part, the exchange, then K34;
* ``torch``: :func:`sharded_fct_ale_step`, the plain stages per part (any
  device and float dtype; the f64 correctness gate).

The default, ``backend=None``, follows ``devices``: "cuda" when every
device is a CUDA device, "torch" when every one is the CPU, and a mix
raises (:func:`~fesom2_accelerate_tpu_torch.config.resolve_backend`).

Two exchange forms (SURVEY §2.6), both index ops that write the halo
columns in place, with ``.to(device)`` where parts sit on different
devices:

* ``ppermute``: per receiving part, the packed multi-hop send lists of
  each owner (the point-to-point ``exchange_nod``; volume ~ halo size);
* ``allgather``: every owned block concatenated, then each part's halo
  columns taken from it (volume P*B).

Halo columns that hold no node keep what the kernels wrote there; no
gather reads them.  In iterative mode the new ``fct_LO`` is exchanged after
stage c, so the next iteration's K1 sees current halo values.

Tracers (``tracers=Tb``, cuda only, as the JAX package batches on its
Pallas backend only): each per-tracer field of a part is [Tb, rows, cols]
and ``hnode``/``hnode_new`` are shared [L, 2H+B]; every phase runs its
kernels once for all tracers, and one halo fill per field moves every
tracer's halo columns, as the JAX package's one exchange does.  The
launches and exchange ops of a step do not depend on Tb.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig, resolve_backend
from fesom2_accelerate_tpu_torch.mesh.topology import Mesh
from fesom2_accelerate_tpu_torch.model import fct_ale as single
from fesom2_accelerate_tpu_torch.ops.cuda import step as cstep
from fesom2_accelerate_tpu_torch.ops.meshdata import (
    MeshData,
    build_mesh_data,
    check_edge_order,
)
from fesom2_accelerate_tpu_torch.parallel import partition as part_mod
from fesom2_accelerate_tpu_torch.parallel.partition import PartitionedMesh

# field layout by name (a small mesh may have as many edges as nodes)
EDGE_FIELDS = frozenset({"fct_adf_h", "fct_adf_h_limited"})


def _halo_fill(xs: list, hmaps: list, B: int, H: int) -> list:
    """All-gather form: every part's owned block [.., H:H+B] concatenated
    (once per device), then each part's 2H halo columns taken from it, in
    place.  ``hmaps[p]`` = (halo columns, their flat indices q*B + i into
    the concatenation), long tensors on part p's device."""
    flat = {}
    for x, (cols, src) in zip(xs, hmaps):
        if x.device not in flat:
            flat[x.device] = torch.cat([y[..., H:H + B].to(x.device)
                                        for y in xs], dim=-1)
        x.index_copy_(x.dim() - 1, cols, flat[x.device].index_select(-1, src))
    return xs


def _halo_fill_nbr(xs: list, smaps: list) -> list:
    """Packed point-to-point form, multi-hop: ``smaps[p]`` lists, for each
    part q that owns some of part p's halo nodes, (q, the owned columns q
    sends, long on q's device; the halo columns they land in, long on p's
    device).  Each pair moves one packed slab, in place."""
    for x, sources in zip(xs, smaps):
        for q, send_cols, cols in sources:
            x.index_copy_(x.dim() - 1, cols,
                          xs[q].index_select(-1, send_cols).to(x.device))
    return xs


def _exchange_maps(pm: PartitionedMesh, mode: str, devices: list) -> list:
    """Per-part index tensors of the halo fill of ``mode``."""
    H, B = pm.H, pm.B
    hi_cols = np.arange(H + B, H + B + H)
    cols = np.concatenate([np.arange(H), hi_cols])

    def long(a, p):
        return torch.tensor(np.asarray(a, np.int64), device=devices[p])

    if mode == "allgather":
        return [(long(cols, p), long(np.concatenate([
            pm.halo_lo_src_part[p] * B + pm.halo_lo_src_idx[p],
            pm.halo_hi_src_part[p] * B + pm.halo_hi_src_idx[p]]), p))
            for p in range(pm.n_parts)]
    # hop r of the JAX package's _halo_fill_nbr: halo column c of part p
    # takes slot pos[c] of the slab that part p -/+ r packs with its send list
    smaps = []
    for p in range(pm.n_parts):
        sources = []
        for r in range(1, pm.neighbor_radius + 1):
            for q, hop, pos, sends, base in (
                    (p - r, pm.halo_lo_hop, pm.halo_lo_pos, pm.hop_send_up,
                     0),
                    (p + r, pm.halo_hi_hop, pm.halo_hi_pos, pm.hop_send_dn,
                     H + B)):
                c = np.nonzero(hop[p] == r)[0]
                if len(c):
                    send_cols = H + sends[r - 1][q, pos[p, c]]
                    sources.append((q, long(send_cols, q),
                                    long(base + c, p)))
        smaps.append(sources)
    return smaps


def fix_edge_ids(pm: PartitionedMesh, p: int) -> np.ndarray:
    """The ids of part p's real local edges with an endpoint in a halo
    column: the only b3 horizontal work that waits for the exchanged
    factors.  The edge form of ``build_pallas_data``'s boundary tiles
    (``ops/pallas/step.py:549-575``), exact: no padding, no repeated id."""
    n_real = int(np.sum(pm.local_edges_global[p] >= 0))
    halo = np.ones(pm.n_local, dtype=bool)
    halo[pm.H:pm.H + pm.B] = False
    ends = pm.local_meshes[p].edges[:n_real]
    return np.nonzero(halo[ends].any(axis=1))[0].astype(np.int32)


def sharded_fct_ale_step(mds: list, cfg: FctAleConfig, halo_fill,
                         states: list) -> list:
    """One plain-PyTorch step on every part (the JAX package's XLA-path
    ``sharded_fct_ale_step``, phase by phase over the parts).  b3 vertical
    runs on the pre-exchange factors, whose owned columns are final, as the
    reference's inter_comm phase overlaps the MPI wait."""
    parts = list(zip(mds, states))
    lims = [single.pre_comm(md, cfg, s["ttf"], s["fct_LO"], s["fct_adf_v"],
                            s["fct_adf_h"]) for md, s in parts]
    verts = [single.inter_comm(md, cfg, lim["fct_plus"], lim["fct_minus"],
                               s["fct_adf_v"])
             for (md, s), lim in zip(parts, lims)]
    halo_fill([lim["fct_plus"] for lim in lims])
    halo_fill([lim["fct_minus"] for lim in lims])
    outs = [single.update_step(
        md, cfg, s, lim, vert,
        single.post_comm(md, cfg, lim["fct_plus"], lim["fct_minus"],
                         s["fct_adf_h"]))
        for (md, s), lim, vert in zip(parts, lims, verts)]
    if cfg.iter_yn:
        halo_fill([o["fct_LO"] for o in outs])
    return outs


def sharded_fct_ale_step_cuda(mds: list, cfg: FctAleConfig, halo_fill,
                              states: list, fix_ids: list | None) -> list:
    """One step of the CUDA kernels on every part: split mode when
    ``fix_ids`` (per part, int32 on the part's device) is given, fused
    mode when it is None.  Launch order, each phase over all parts: K1, K2
    -> [K3] -> exchange -> K3fix, K4 | K34 -> [fct_LO exchange].  A batched
    state (per-tracer fields [Tb, ...]) takes the same launches and
    exchanges, each over every tracer."""
    parts = list(zip(mds, states))
    pres = [cstep.pre_exchange(md, cfg, s) for md, s in parts]
    if fix_ids is not None:
        edges = [cstep.limit_edges(md, cfg, s, pre)
                 for (md, s), pre in zip(parts, pres)]
    halo_fill([pre["fct_plus"] for pre in pres])
    halo_fill([pre["fct_minus"] for pre in pres])
    if fix_ids is None:
        outs = [cstep.post_exchange_fused(md, cfg, s, pre)
                for (md, s), pre in zip(parts, pres)]
    else:
        outs = [cstep.post_exchange_split(md, cfg, s, pre, e, ids)
                for (md, s), pre, e, ids in zip(parts, pres, edges, fix_ids)]
    if cfg.iter_yn:
        halo_fill([o["fct_LO"] for o in outs])
    return outs


class ShardedFctAleSolver:
    """Domain-decomposed FCT-ALE over P = len(devices) parts in one process.

    Usage::

        sh = ShardedFctAleSolver(mesh, FctAleConfig(),
                                 devices=["cuda:0"] * 4)
        state = sh.init_state(fields)       # global numpy -> per-part lists
        state = sh.run(state, n_steps=10)
        ttf = sh.gather_node(state["ttf"])  # owned columns -> global numpy

    The state is a dict of lists: ``state[k][p]`` is part p's tensor,
    [rows, 2H+B] for node fields and [L, Ed_loc] for edge fields, on
    ``devices[p]``; with ``tracers=Tb`` > 1 each per-tracer field has a
    leading tracer axis ([Tb, rows, 2H+B], [Tb, L, Ed_loc]) and ``hnode``,
    ``hnode_new`` stay [L, 2H+B].

    backend: None (the default: "cuda" when every device is a CUDA
    device, "torch" when every one is the CPU, a mix raises), "torch"
    (plain stages, any devices and float dtype) or "cuda" (the CUDA
    kernels; every device must be a CUDA device).  fused
    (cuda only): exchange, then K34, instead of the split K3 -> exchange ->
    K3fix -> K4; it needs each part's edges sorted by first endpoint
    (``MeshData.ed_ptr``).  exchange: "auto" (ppermute when P > 1, else
    allgather), "ppermute" or "allgather".  part_counts: per-part
    owned-node counts (an RCB partition, ``mesh.ordering.rcb_order``).
    tracers (cuda only): Tb tracers a step, the global fields of
    :meth:`init_state` then [Tb, rows, N] (``hnode``, ``hnode_new``
    [L, N])."""

    def __init__(self, mesh: Mesh, cfg: FctAleConfig = FctAleConfig(),
                 backend: str | None = None, *, devices: list,
                 exchange: str = "auto",
                 part_counts: np.ndarray | None = None, tracers: int = 1,
                 fused: bool = False):
        if tracers < 1:
            raise ValueError(f"tracers must be >= 1, got {tracers}")
        devices = [torch.device(d) for d in devices]
        backend = resolve_backend(backend, devices)
        if backend == "torch":
            if fused:
                raise ValueError("fused sharded mode is cuda-only")
            if tracers != 1:
                raise ValueError("tracer batching is cuda-only: the CUDA "
                                 "kernels take the tracer axis")
        if exchange == "auto":
            exchange = "ppermute" if len(devices) > 1 else "allgather"
        if exchange not in ("ppermute", "allgather"):
            raise ValueError(f"exchange must be 'auto', 'ppermute' or "
                             f"'allgather', got {exchange!r}")
        self.mesh = mesh
        self.cfg = cfg
        self.backend = backend
        self.fused = fused
        self.tracers = tracers
        self.devices = devices
        self.n_parts = len(devices)
        self.exchange_mode = exchange
        self.pm: PartitionedMesh = part_mod.partition_mesh(
            mesh, self.n_parts, counts=part_counts)
        pm = self.pm
        # each part's global node / edge ids (clamped) and which are real,
        # to scatter global fields: index_select, where the numpy
        # scatter_*_field takes seconds for a [Tb, L, N] field
        self._cols = {
            edge: [(torch.from_numpy(np.maximum(g, 0).astype(np.int64)),
                    torch.from_numpy(g >= 0)) for g in ids]
            for edge, ids in ((False, pm.local_nodes_global),
                              (True, pm.local_edges_global))}
        self.mds: list[MeshData] = [
            build_mesh_data(m, cfg.dtype, d)
            for m, d in zip(pm.local_meshes, devices)]
        if backend == "cuda" and fused:
            for md in self.mds:
                check_edge_order(md.edges)  # H-K34's edge ranges
        maps = _exchange_maps(pm, exchange, devices)
        if exchange == "ppermute":
            self.halo_fill = functools.partial(_halo_fill_nbr, smaps=maps)
        else:
            self.halo_fill = functools.partial(_halo_fill, hmaps=maps,
                                               B=pm.B, H=pm.H)
        # split mode's K3fix edges per part (int32 on the part's device)
        self.fix_ids = None
        if backend == "torch":
            self._step_parts = functools.partial(
                sharded_fct_ale_step, self.mds, cfg, self.halo_fill)
        else:
            if not fused:
                self.fix_ids = [torch.tensor(fix_edge_ids(pm, p), device=d)
                                for p, d in enumerate(devices)]
            self._step_parts = functools.partial(
                sharded_fct_ale_step_cuda, self.mds, cfg, self.halo_fill,
                fix_ids=self.fix_ids)

    # ---- state movement -------------------------------------------------
    def init_state(self, fields: dict) -> dict:
        """Global numpy fields -> per-part tensors of the config dtype on
        each part's device (pad columns 0).  With ``tracers`` > 1 each
        per-tracer field is [Tb, rows, N] (or [Tb, L, Ed]) and ``hnode``,
        ``hnode_new`` are [L, N]."""
        out = {}
        for k, v in fields.items():
            v = np.asarray(v)
            edge = k in EDGE_FIELDS
            want = self.mesh.n_edges if edge else self.mesh.n_nodes
            if v.shape[-1] != want:
                raise ValueError(f"{k} has shape {v.shape}, expected "
                                 f"[..., {want}]")
            if self.tracers > 1 and (
                    v.shape[:-2] != (() if k in cstep.BATCH_SHARED
                                     else (self.tracers,))):
                raise ValueError(
                    f"{k} has shape {v.shape}: with {self.tracers} tracers "
                    f"a per-tracer field is [{self.tracers}, rows, cols], "
                    f"hnode and hnode_new are shared [rows, cols]")
            # part_mod.scatter_*_field's values: each part's columns, 0 in
            # the pad columns
            src = torch.from_numpy(np.require(v, requirements=["C", "W"]))
            out[k] = [(src.index_select(-1, cols) * live).to(
                dtype=self.cfg.dtype, device=d)
                for (cols, live), d in zip(self._cols[edge], self.devices)]
        return out

    def gather_node(self, tensors: list) -> np.ndarray:
        """Per-part node tensors -> the global [.., N] numpy field, from
        the owned columns (a tracer axis stays in front)."""
        return part_mod.gather_node_field(
            self.pm, np.stack([t.detach().cpu().numpy() for t in tensors]))

    def gather_state(self, state: dict) -> dict:
        """Per-part state -> global natural-layout numpy dict (per-tracer
        fields [Tb, ...] when the state has a tracer axis)."""
        out = {}
        for k, v in state.items():
            local = np.stack([t.detach().cpu().numpy() for t in v])
            out[k] = (part_mod.gather_edge_field if k in EDGE_FIELDS
                      else part_mod.gather_node_field)(self.pm, local)
        return out

    def save_checkpoint(self, path, state: dict, step: int = 0) -> None:
        raise NotImplementedError(
            "checkpoints: runtime/checkpoint.py is not ported yet (ROADMAP "
            "Queue A item 3, Checkpoints)")

    def load_checkpoint(self, path):
        raise NotImplementedError(
            "checkpoints: runtime/checkpoint.py is not ported yet (ROADMAP "
            "Queue A item 3, Checkpoints)")

    # ---- stepping -------------------------------------------------------
    def step(self, state: dict) -> dict:
        parts = [{k: v[p] for k, v in state.items()}
                 for p in range(self.n_parts)]
        outs = self._step_parts(parts)
        return {k: [o[k] for o in outs] for k in outs[0]}

    def run(self, state: dict, n_steps: int) -> dict:
        """n_steps steps; the carry keeps the input's keys and drops the
        diagnostic ones, as the single-device solver's run does."""
        for _ in range(n_steps):
            new = self.step(state)
            state = {k: new[k] for k in state}
        return state
