"""Domain-decomposed FCT-ALE step: P parts in one process or over several
(PyTorch port).

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
    pre-exchange factors) on every part, the exchange, then K4-fix: one
    launch of K4 in its FIX form, which limits again only the edges that
    touch a halo column, with the exchanged factors, and sums them into
    stage c (what K3fix then K4 did in two launches): 4 launches a part;
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

``run`` on the cuda backend with every part on one card replays the steps
as CUDA graphs (:mod:`~fesom2_accelerate_tpu_torch.runtime.graphs`, the
JAX solver's ``jit(lax.scan)``): the kernels and the halo fills' index
ops of a block of steps in one enqueue, bit-identical to the loop of
``step``.  It does so where the host's enqueue of the parts' launches sets
the pace of a step (timed once per state signature, as on core2 at 4
parts and one tracer), else it runs the loop.  The torch backend, and
parts spread over several cards (a graph captures one device), run the
Python loop of steps.

Checkpoints (:mod:`~fesom2_accelerate_tpu_torch.runtime.checkpoint`, npz)
hold the gathered global state, so a run saved at P parts resumes at any
partition, or on one device through ``FctAleSolver.init_state``.

Across processes (the JAX package's ``_multiproc``, a FESOM2 run's MPI
ranks), each process holds its own parts and the halo fill sends the
slabs that cross processes point to point over ``torch.distributed``
(:class:`ProcessHaloFill`; gloo stages a CUDA part's slab through pinned
host memory, :class:`Wire`).  The gathers and the checkpoint's write are
collectives; a run is the host's loop of steps (a CUDA graph cannot
capture a send).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from fesom2_accelerate_tpu_torch.config import FctAleConfig, resolve_backend
from fesom2_accelerate_tpu_torch.mesh.topology import Mesh
from fesom2_accelerate_tpu_torch.model import fct_ale as single
from fesom2_accelerate_tpu_torch.ops.cuda import step as cstep
from fesom2_accelerate_tpu_torch.ops.meshdata import (
    MeshData,
    build_mesh_data,
    check_edge_order,
)
from fesom2_accelerate_tpu_torch.parallel import distributed
from fesom2_accelerate_tpu_torch.parallel import partition as part_mod
from fesom2_accelerate_tpu_torch.parallel.partition import PartitionedMesh
from fesom2_accelerate_tpu_torch.runtime import checkpoint as ckpt
from fesom2_accelerate_tpu_torch.runtime import graphs

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


def exchange_pairs(pm: PartitionedMesh) -> list:
    """Every packed slab of the point-to-point exchange: (p, q, hop,
    send_cols, cols), part q sending owned columns ``send_cols`` of its
    own into halo columns ``cols`` of part p, q = p + hop.  A pure
    function of the partition, in one order (p, then |hop|, then the low
    side before the high one), so processes that hold different parts
    derive the same list and match their sends and receives by it."""
    H, B = pm.H, pm.B
    pairs = []
    # hop r of the JAX package's _halo_fill_nbr: halo column c of part p
    # takes slot pos[c] of the slab that part p -/+ r packs with its send list
    for p in range(pm.n_parts):
        for r in range(1, pm.neighbor_radius + 1):
            for q, hop, pos, sends, base in (
                    (p - r, pm.halo_lo_hop, pm.halo_lo_pos, pm.hop_send_up,
                     0),
                    (p + r, pm.halo_hi_hop, pm.halo_hi_pos, pm.hop_send_dn,
                     H + B)):
                c = np.nonzero(hop[p] == r)[0]
                if len(c):
                    pairs.append((p, q, q - p, H + sends[r - 1][q, pos[p, c]],
                                  base + c))
    return pairs


def _long(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.int64), device=device)


def _allgather_maps(pm: PartitionedMesh, parts: list,
                    devices: list) -> list:
    """The all-gather form's ``hmaps`` of each of ``parts`` (global ids),
    on ``devices`` (one a part): its 2H halo columns and their flat
    indices q*B + i into every part's owned block, concatenated in part
    order."""
    H, B = pm.H, pm.B
    cols = np.concatenate([np.arange(H), np.arange(H + B, 2 * H + B)])
    return [(_long(cols, d), _long(np.concatenate([
        pm.halo_lo_src_part[p] * B + pm.halo_lo_src_idx[p],
        pm.halo_hi_src_part[p] * B + pm.halo_hi_src_idx[p]]), d))
        for p, d in zip(parts, devices)]


def _exchange_maps(pm: PartitionedMesh, mode: str, devices: list) -> list:
    """Per-part index tensors of the halo fill of ``mode``."""
    if mode == "allgather":
        return _allgather_maps(pm, range(pm.n_parts), devices)
    smaps = [[] for _ in range(pm.n_parts)]
    for p, q, _, send_cols, c in exchange_pairs(pm):
        smaps[p].append((q, _long(send_cols, devices[q]),
                         _long(c, devices[p])))
    return smaps


class Wire:
    """How tensors cross between processes: ``name`` is the transport.

    * "nccl": device tensors, sent as they are;
    * "gloo": CPU parts' tensors, sent as they are;
    * "gloo, staged through pinned host memory": gloo takes CPU tensors
      only, so a CUDA part's slab is copied into pinned host memory, the
      stream is synchronized (:meth:`ready`) before anything is sent, and
      what arrives is copied to the card on the current stream."""

    def __init__(self, backend: str, devices: list):
        self.cards = sorted({d for d in devices if d.type == "cuda"},
                            key=str)
        self.staged = backend != "nccl" and bool(self.cards)
        self.name = ("nccl" if backend == "nccl" else
                     "gloo, staged through pinned host memory"
                     if self.staged else "gloo")

    def out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as it is sent (a pinned host copy, enqueued, if staged)."""
        if not self.staged or t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    def ready(self) -> None:
        """Waits for the copies of :meth:`out` (and the kernels before
        them) before anything is sent."""
        if self.staged:
            for d in self.cards:
                torch.cuda.current_stream(d).synchronize()

    def buffer(self, shape, dtype, device: torch.device) -> torch.Tensor:
        """A receive buffer for a tensor bound for ``device``."""
        if self.staged and device.type == "cuda":
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=device)

    def into(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """A received tensor on ``device`` (copied on the current stream)."""
        return t.to(device, non_blocking=True)


def _gather_owned(blocks: list, owners: list, wire: Wire) -> tuple:
    """Every part's block from every rank, ``blocks`` this rank's (its
    parts', in order): (the blocks in global part order, the bytes this
    rank sent to each other rank).  One ``all_gather`` that every rank
    enters, of this rank's blocks stacked and zero-padded to the most
    parts a rank holds (it takes one shape from every rank); the blocks
    come back on the host when ``wire`` stages."""
    width = max(owners.count(r) for r in set(owners))
    blocks = blocks + [torch.zeros_like(blocks[0])] * (width - len(blocks))
    mine = wire.out(torch.stack(blocks))
    wire.ready()
    got = [wire.buffer(mine.shape, mine.dtype, blocks[0].device)
           for _ in range(dist.get_world_size())]
    dist.all_gather(got, mine)
    seen = [0] * len(got)
    out = []
    for r in owners:
        out.append(got[r][seen[r]])
        seen[r] += 1
    return out, mine.numel() * mine.element_size()


class ProcessHaloFill:
    """The halo fill of parts spread over processes: ``xs`` holds this
    rank's parts (``local``, global part ids, in order).

    * ppermute: each slab of :func:`exchange_pairs` whose two parts share
      this process stays an index op (:func:`_halo_fill_nbr`); a slab
      across processes is sent by the owner of q, ``xs[q].index_select(-1,
      send_cols)``, and received by the owner of p into a buffer of that
      shape, then ``index_copy_``-ed into its halo columns.  All the
      cross-process ops of one call go in one ``batch_isend_irecv``, tagged
      by their place in the list of cross-process slabs, which every rank
      derives alike;
    * allgather: every rank's owned blocks (``[.., H:H+B]`` of each of its
      parts) in one ``all_gather`` (:func:`_gather_owned`), then each
      part's halo columns taken from them, as :func:`_halo_fill` does.

    ``owners[p]`` is the rank of part p, ``devices`` this rank's parts'
    devices.  ``messages`` and ``nbytes`` count what this rank sent since
    they were last set to 0."""

    def __init__(self, pm: PartitionedMesh, mode: str, owners: list,
                 rank: int, devices: list, wire: Wire):
        self.wire = wire
        self.mode = mode
        self.owners = owners
        self.H, self.B = pm.H, pm.B
        local = [p for p, r in enumerate(owners) if r == rank]
        slot = {p: i for i, p in enumerate(local)}
        self.messages = self.nbytes = 0
        if mode == "allgather":
            self.hmaps = _allgather_maps(pm, local, devices)
            return
        self.smaps = [[] for _ in local]
        self.sends, self.recvs = [], []
        tag = 0
        for p, q, _, send_cols, cols in exchange_pairs(pm):
            if owners[p] == owners[q]:
                if owners[p] == rank:
                    self.smaps[slot[p]].append((
                        slot[q], _long(send_cols, devices[slot[q]]),
                        _long(cols, devices[slot[p]])))
                continue
            if owners[q] == rank:
                i = slot[q]
                self.sends.append((tag, owners[p], i,
                                   _long(send_cols, devices[i])))
            if owners[p] == rank:
                i = slot[p]
                self.recvs.append((tag, owners[q], i,
                                   _long(cols, devices[i])))
            tag += 1

    def __call__(self, xs: list) -> list:
        if self.mode == "allgather":
            return self._allgather(xs)
        slabs = [(tag, dst, self.wire.out(xs[i].index_select(-1, cols)))
                 for tag, dst, i, cols in self.sends]
        self.wire.ready()
        ops = [dist.P2POp(dist.isend, t, dst, tag=tag)
               for tag, dst, t in slabs]
        bufs = []
        for tag, src, i, cols in self.recvs:
            x = xs[i]
            buf = self.wire.buffer(x.shape[:-1] + (len(cols),), x.dtype,
                                   x.device)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        _halo_fill_nbr(xs, self.smaps)
        for req in reqs:
            req.wait()
        for (_, _, i, cols), buf in zip(self.recvs, bufs):
            x = xs[i]
            x.index_copy_(x.dim() - 1, cols, self.wire.into(buf, x.device))
        self.messages += len(slabs)
        self.nbytes += sum(t.numel() * t.element_size() for _, _, t in slabs)
        return xs

    def _allgather(self, xs: list) -> list:
        H, B = self.H, self.B
        blocks, sent = _gather_owned([x[..., H:H + B] for x in xs],
                                     self.owners, self.wire)
        flat = {}
        for x, (cols, src) in zip(xs, self.hmaps):
            if x.device not in flat:
                flat[x.device] = self.wire.into(torch.cat(blocks, dim=-1),
                                                x.device)
            x.index_copy_(x.dim() - 1, cols,
                          flat[x.device].index_select(-1, src))
        others = dist.get_world_size() - 1
        self.messages += others
        self.nbytes += others * sent
        return xs


def fix_edge_ids(pm: PartitionedMesh, p: int) -> np.ndarray:
    """The ids of part p's real local edges with an endpoint in a halo
    column: the only b3 horizontal work that waits for the exchanged
    factors, which K4-fix does on the owned columns ``(pm.H, pm.H +
    pm.B)`` (``kernels.fixup_edges`` gives these ids) and K3fix on this
    list.  The edge form of ``build_pallas_data``'s boundary tiles
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
                              states: list, owned: tuple | None) -> list:
    """One step of the CUDA kernels on every part: split mode when
    ``owned`` (the owned columns (H, H + B), the same on every part) is
    given, fused mode when it is None.  Launch order, each phase over all
    parts: K1, K2 -> [K3] -> exchange -> K4-fix | K34 -> [fct_LO
    exchange].  A batched state (per-tracer fields [Tb, ...]) takes the
    same launches and exchanges, each over every tracer."""
    parts = list(zip(mds, states))
    pres = [cstep.pre_exchange(md, cfg, s) for md, s in parts]
    if owned is not None:
        edges = [cstep.limit_edges(md, cfg, s, pre)
                 for (md, s), pre in zip(parts, pres)]
    halo_fill([pre["fct_plus"] for pre in pres])
    halo_fill([pre["fct_minus"] for pre in pres])
    if owned is None:
        outs = [cstep.post_exchange_fused(md, cfg, s, pre)
                for (md, s), pre in zip(parts, pres)]
    else:
        outs = [cstep.post_exchange_split(md, cfg, s, pre, e, owned)
                for (md, s), pre, e in zip(parts, pres, edges)]
    if cfg.iter_yn:
        halo_fill([o["fct_LO"] for o in outs])
    return outs


class ShardedFctAleSolver:
    """Domain-decomposed FCT-ALE over P = len(devices) parts, in one
    process or over several.

    Usage::

        sh = ShardedFctAleSolver(mesh, FctAleConfig(),
                                 devices=["cuda:0"] * 4)
        state = sh.init_state(fields)       # global numpy -> per-part lists
        state = sh.run(state, n_steps=10)   # CUDA graphs on one card
        ttf = sh.gather_node(state["ttf"])  # owned columns -> global numpy
        sh.save_checkpoint("ckpt", state, step=10)
        sh2 = ShardedFctAleSolver(mesh, FctAleConfig(),
                                  devices=["cuda:0"] * 2)
        state, step = sh2.load_checkpoint("ckpt")  # another partition

    Across processes (``parallel/distributed.py``)::

        dist.init_distributed()
        dev = dist.bind_device()
        sh = ShardedFctAleSolver(mesh, cfg,
                                 devices=dist.global_devices([dev] * 2))

    An entry of ``devices`` is a device (a part of this process) or a
    ``distributed.PartDevice(rank, device)``; the solver is
    multi-process (``multiprocess``) when some part belongs to another
    rank.  Every process then partitions the whole mesh (redundantly, as
    the JAX package does and as each MPI rank builds its subdomain), and
    builds mesh data and state only for its own parts, ``local_parts``
    (global part ids, in order): ``state[k]`` lists those parts' tensors,
    and ``devices``, ``mds`` follow them.  The halo fill crosses
    processes point to point (``ProcessHaloFill``, over ``transport``);
    ``gather_node``, ``gather_state`` and ``save_checkpoint`` are
    collectives that every rank enters; ``run`` is the host's loop.

    The state is a dict of lists: ``state[k][i]`` is the tensor of part
    ``local_parts[i]`` (part i in one process), [rows, 2H+B] for node
    fields and [L, Ed_loc] for edge fields, on ``devices[i]``; with
    ``tracers=Tb`` > 1 each per-tracer field has a leading tracer axis
    ([Tb, rows, 2H+B], [Tb, L, Ed_loc]) and ``hnode``, ``hnode_new`` stay
    [L, 2H+B].

    backend: None (the default: "cuda" when every device is a CUDA
    device, "torch" when every one is the CPU, a mix raises), "torch"
    (plain stages, any devices and float dtype) or "cuda" (the CUDA
    kernels; every device must be a CUDA device).  fused
    (cuda only): exchange, then K34, instead of the split K3 -> exchange ->
    K4-fix; it needs each part's edges sorted by first endpoint
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
        rank = distributed.process_rank()
        parts = [d if isinstance(d, distributed.PartDevice)
                 else distributed.PartDevice(rank, torch.device(d))
                 for d in devices]
        every_device = [torch.device(d.device) for d in parts]
        owners = [d.rank for d in parts]
        backend = resolve_backend(backend, every_device)
        if backend == "torch":
            if fused:
                raise ValueError("fused sharded mode is cuda-only")
            if tracers != 1:
                raise ValueError("tracer batching is cuda-only: the CUDA "
                                 "kernels take the tracer axis")
        if exchange == "auto":
            exchange = "ppermute" if len(parts) > 1 else "allgather"
        if exchange not in ("ppermute", "allgather"):
            raise ValueError(f"exchange must be 'auto', 'ppermute' or "
                             f"'allgather', got {exchange!r}")
        self._owners = owners
        self.local_parts = [p for p, r in enumerate(owners) if r == rank]
        if not self.local_parts:
            raise ValueError(f"rank {rank} holds none of the {len(parts)} "
                             f"parts: {[tuple(map(str, d)) for d in parts]}")
        self.multiprocess = any(r != rank for r in owners)
        self.mesh = mesh
        self.cfg = cfg
        self.backend = backend
        self.devices = [every_device[p] for p in self.local_parts]
        self.n_parts = len(parts)
        self.exchange_mode = exchange
        self.pm: PartitionedMesh = part_mod.partition_mesh(
            mesh, self.n_parts, counts=part_counts)
        pm = self.pm
        # each local part's global node / edge ids (clamped) and which are
        # real, to scatter global fields: index_select, where the numpy
        # scatter_*_field takes seconds for a [Tb, L, N] field
        self._cols = {
            edge: [(torch.from_numpy(np.maximum(ids[p], 0).astype(np.int64)),
                    torch.from_numpy(ids[p] >= 0)) for p in self.local_parts]
            for edge, ids in ((False, pm.local_nodes_global),
                              (True, pm.local_edges_global))}
        self.mds: list[MeshData] = [
            build_mesh_data(pm.local_meshes[p], cfg.dtype, d)
            for p, d in zip(self.local_parts, self.devices)]
        if self.multiprocess:
            self.wire = Wire(dist.get_backend(), self.devices)
            self.transport = self.wire.name
            self.halo_fill = ProcessHaloFill(pm, exchange, owners, rank,
                                             self.devices, self.wire)
            print(f"rank {rank}: parts {self.local_parts} of "
                  f"{self.n_parts} on {[str(d) for d in self.devices]}, "
                  f"{exchange} exchange over {self.transport}", flush=True)
        else:
            self.wire = None
            self.transport = "in-process"
            maps = _exchange_maps(pm, exchange, self.devices)
            if exchange == "ppermute":
                self.halo_fill = functools.partial(_halo_fill_nbr,
                                                   smaps=maps)
            else:
                self.halo_fill = functools.partial(_halo_fill, hmaps=maps,
                                                   B=pm.B, H=pm.H)
        self.set_step(backend == "cuda", fused, tracers)
        # a graph captures one device, and no gloo send
        self._graphs = (graphs.StepGraphs(self.devices[0])
                        if backend == "cuda" and not self.multiprocess
                        and len(set(self.devices)) == 1 else None)

    def set_step(self, kernels: bool, fused: bool = False,
                 tracers: int = 1) -> None:
        """Wires :meth:`step`: the plain stages, or with ``kernels`` the
        CUDA backend's step, split or fused, at ``tracers`` tracers (what
        ``backend`` chose at construction).  On a CPU solver the kernel
        step runs every kernel wrapper's plain version, the form the CPU
        tests hold against the JAX package."""
        self.fused, self.tracers = fused, tracers
        # split mode's owned columns, the same on every part: K4-fix limits
        # again the edges with an endpoint outside them
        self.owned = None
        if not kernels:
            self._step_parts = functools.partial(
                sharded_fct_ale_step, self.mds, self.cfg, self.halo_fill)
            return
        if fused:
            for md in self.mds:
                check_edge_order(md.edges)  # H-K34's edge ranges
        else:
            self.owned = (self.pm.H, self.pm.H + self.pm.B)
        self._step_parts = functools.partial(
            sharded_fct_ale_step_cuda, self.mds, self.cfg, self.halo_fill,
            owned=self.owned)

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

    def _every_part(self, tensors: list, edge: bool) -> np.ndarray:
        """Every part's tensor, stacked [P, ...] in numpy.  Across
        processes an ``all_gather`` that every rank enters, of the owned
        blocks ``[.., H:H+B]`` of node fields (the other columns stay 0)
        and the whole tensors of edge fields."""
        if not self.multiprocess:
            return np.stack([t.detach().cpu().numpy() for t in tensors])
        H, B = self.pm.H, self.pm.B
        blocks, _ = _gather_owned(
            [t.detach() if edge else t.detach()[..., H:H + B]
             for t in tensors], self._owners, self.wire)
        blocks = [b.cpu().numpy() for b in blocks]
        out = np.zeros((self.n_parts,) + tuple(tensors[0].shape),
                       dtype=blocks[0].dtype)
        for p, block in enumerate(blocks):
            if edge:
                out[p] = block
            else:
                out[p, ..., H:H + B] = block
        return out

    def gather_node(self, tensors: list) -> np.ndarray:
        """Per-part node tensors -> the global [.., N] numpy field, from
        the owned columns (a tracer axis stays in front).  Across
        processes every rank must call it, and every rank gets the whole
        field, as the JAX ``process_allgather``."""
        return part_mod.gather_node_field(
            self.pm, self._every_part(tensors, edge=False))

    def gather_state(self, state: dict) -> dict:
        """Per-part state -> global natural-layout numpy dict (per-tracer
        fields [Tb, ...] when the state has a tracer axis); collective
        across processes, as :meth:`gather_node`."""
        out = {}
        for k, v in state.items():
            edge = k in EDGE_FIELDS
            local = self._every_part(v, edge)
            out[k] = (part_mod.gather_edge_field if edge
                      else part_mod.gather_node_field)(self.pm, local)
        return out

    def save_checkpoint(self, path, state: dict, step: int = 0) -> bool:
        """Writes the gathered global state (:meth:`gather_state`) with
        the mesh fingerprint and the config (``runtime/checkpoint.py``,
        npz): it loads at any partition, in the JAX package as well.
        Across processes every rank gathers (a collective), rank 0 alone
        writes, and every rank waits at a barrier until it has; a
        one-process solver writes whatever its rank.  Returns whether this
        process wrote the files."""
        gathered = self.gather_state(state)
        writes = not self.multiprocess or distributed.process_rank() == 0
        if writes:
            ckpt.save_checkpoint(path, gathered, self.mesh, self.cfg,
                                 step=step)
        if self.multiprocess:
            dist.barrier()
        return writes

    def load_checkpoint(self, path) -> tuple:
        """(per-part state, step) from a checkpoint, scattered through
        :meth:`init_state`: a run saved at P parts resumes at this
        solver's partition (each rank reads the file and takes its own
        parts).  Raises on another mesh, vlimit, iter_yn or
        tracer count."""
        st, step = ckpt.load_checkpoint(path, self.mesh, self.cfg)
        lead = st["ttf"].shape[:-2]
        if lead != ((self.tracers,) if self.tracers > 1 else ()):
            raise ValueError(
                f"checkpoint {path} holds ttf of shape {st['ttf'].shape}: "
                f"{lead[0] if lead else 1} tracers, this solver runs "
                f"{self.tracers}")
        return self.init_state(st), step

    # ---- stepping -------------------------------------------------------
    def step(self, state: dict) -> dict:
        parts = [{k: v[i] for k, v in state.items()}
                 for i in range(len(self.local_parts))]
        outs = self._step_parts(parts)
        return {k: [o[k] for o in outs] for k in outs[0]}

    def run(self, state: dict, n_steps: int) -> dict:
        """n_steps steps; the carry keeps the input's keys and drops the
        diagnostic ones, as the single-device solver's run does.  As CUDA
        graphs on the cuda backend with every part on one card where the
        host sets the pace (``graphs.StepGraphs.run``); else the Python
        loop of :meth:`step`."""
        if self._graphs is None:
            return graphs.loop(self.step, state, n_steps)
        n = len(self.local_parts)
        flat = self._graphs.run(
            self._step_flat, {(k, p): v[p] for k, v in state.items()
                              for p in range(n)}, n_steps)
        return {k: [flat[k, p] for p in range(n)] for k in state}

    def _step_flat(self, flat: dict) -> dict:
        """:meth:`step` on the state as one dict keyed (field, part), the
        form a graph's carry takes."""
        n = len(self.local_parts)
        keys = dict.fromkeys(k for k, _ in flat)
        new = self.step({k: [flat[k, p] for p in range(n)] for k in keys})
        return {(k, p): v[p] for k, v in new.items() for p in range(n)}
