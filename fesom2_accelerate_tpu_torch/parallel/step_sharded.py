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

The exchange's schedule is the JAX package's
(``fesom2_accelerate_tpu/parallel/step_sharded.py:176-186``,
``ops/pallas/step.py:822-871``, certified by ``tests/test_overlap.py``):
both limiter factors move in one exchange of the pair ``[2, ...]``
(``jnp.stack([plus, minus])``), and the fill is two-phase (``start``,
``finish``; a call does both): it starts right after K2, the compute that
reads no exchanged value (K3 in split mode, b3 vertical in the plain
step) is enqueued while it is in flight, and it finishes, writing the halo
columns, before the compute that reads them.

Two backends:

* ``cuda``: :func:`sharded_fct_ale_step_cuda`, the CUDA kernels per part
  (``ops/cuda/step.py``), in one of two modes:

  - split (the default): K1, K2 on every part, the exchange started, K3
    (every edge limited on the pre-exchange factors) on every part, the
    exchange finished, then K4-fix: one
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
kernels once for all tracers, and one halo fill moves every tracer's
halo columns (the factors' pair is [2, Tb, rows, cols]), as the JAX
package's one exchange does.  The
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
host memory on a side stream while K3 runs, :class:`Wire`; the finish
waits for that staging's events, not for the compute stream).  The
gathers and the checkpoint's write are collectives; a run is the host's
loop of steps (a CUDA graph cannot capture a send).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.distributed as dist

from fesom2_accelerate_tpu_torch.config import FctAleConfig, resolve_backend
from fesom2_accelerate_tpu_torch.mesh.topology import Mesh
from fesom2_accelerate_tpu_torch.model import fct_ale as single
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
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


def _take_allgather(xs: list, hmaps: list, flat) -> list:
    """All-gather form, what each part's halo columns take: ``flat(d)`` is
    every part's owned block [.., H:H+B] concatenated in part order, on
    device d (made once a device), and ``hmaps[p]`` = (part p's 2H halo
    columns, their flat indices q*B + i into it), long tensors on part p's
    device.  Returns, a part, [(halo columns, their values)]."""
    flat = functools.cache(flat)
    return [[(cols, flat(x.device).index_select(-1, src))]
            for x, (cols, src) in zip(xs, hmaps)]


def _take_nbr(xs: list, smaps: list) -> list:
    """Packed point-to-point form, multi-hop, what each part's halo
    columns take: ``smaps[p]`` lists, for each part q that owns some of
    part p's halo nodes, (q, the owned columns q sends, long on q's
    device; the halo columns they land in, long on p's device).  Each pair
    gathers one packed slab.  Returns, a part, [(halo columns, slab)]."""
    return [[(cols, xs[q].index_select(-1, send_cols).to(x.device))
             for q, send_cols, cols in sources]
            for x, sources in zip(xs, smaps)]


def _place(xs: list, taken: list) -> list:
    """Writes what :func:`_take_nbr` / :func:`_take_allgather` took into
    the halo columns of ``xs``, in place."""
    for x, got in zip(xs, taken):
        for cols, vals in got:
            x.index_copy_(x.dim() - 1, cols, vals)
    return xs


class HaloFill:
    """The halo fill of parts in one process, in two phases, as the JAX
    sharded step's exchange runs while compute that reads no exchanged
    value goes on: :meth:`start` takes what every halo column receives
    (from owned columns, which no fill writes), :meth:`finish` writes it
    into the halo columns, in place.  A call does both.  ``mode``: the
    ``ppermute`` form (``maps`` from :func:`_exchange_maps`: the packed
    multi-hop slabs, :func:`_take_nbr`) or the ``allgather`` one
    (:func:`_take_allgather`).  Every op is enqueued on the current
    stream of its device, so a CUDA graph captures the fill as it is."""

    def __init__(self, pm: PartitionedMesh, mode: str, devices: list):
        self.mode = mode
        self.H, self.B = pm.H, pm.B
        self.maps = _exchange_maps(pm, mode, devices)

    def start(self, xs: list) -> tuple:
        if self.mode == "allgather":
            H, B = self.H, self.B
            return xs, _take_allgather(xs, self.maps, lambda d: torch.cat(
                [y[..., H:H + B].to(d) for y in xs], dim=-1))
        return xs, _take_nbr(xs, self.maps)

    def finish(self, pending: tuple) -> list:
        return _place(*pending)

    def __call__(self, xs: list) -> list:
        return self.finish(self.start(xs))


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
      only, so :meth:`out` makes a CUDA part's tensors on a side stream
      of its card, behind an event recorded on the current stream, and
      copies them there into pinned host memory; :meth:`ready` waits for
      the events recorded behind those copies, never for the current
      stream, which goes on with the kernels enqueued after; what arrives
      is copied to the card on the current stream."""

    def __init__(self, backend: str, devices: list):
        self.cards = sorted({d for d in devices if d.type == "cuda"},
                            key=str)
        self.staged = backend != "nccl" and bool(self.cards)
        self.name = ("nccl" if backend == "nccl" else
                     "gloo, staged through pinned host memory"
                     if self.staged else "gloo")
        self._side = {}

    def out(self, make, reads: list) -> tuple:
        """(``make()``, a list of tensors, as it is sent; what
        :meth:`ready` waits on).  Staged, ``make`` runs on each card's side
        stream, after what the current stream has enqueued so far, and its
        CUDA tensors are copied into pinned host memory there; ``reads``
        are the tensors ``make`` reads (kept from reuse until the side
        stream is done with them).  Else ``make()`` on the current
        stream, and nothing to wait on."""
        if not self.staged:
            return make(), []
        with contextlib.ExitStack() as on_side:
            for d in self.cards:
                if d not in self._side:
                    self._side[d] = torch.cuda.Stream(d)
                side = self._side[d]
                side.wait_stream(torch.cuda.current_stream(d))
                on_side.enter_context(torch.cuda.stream(side))
            for t in reads:
                if t.device.type == "cuda":
                    t.record_stream(self._side[t.device])
            sent = []
            for t in make():
                if t.device.type == "cuda":
                    t = torch.empty(t.shape, dtype=t.dtype,
                                    pin_memory=True).copy_(
                                        t, non_blocking=True)
                sent.append(t)
            staged = []
            for d in self.cards:
                ev = torch.cuda.Event()
                ev.record(self._side[d])
                staged.append(ev)
        return sent, staged

    @staticmethod
    def ready(staged: list) -> None:
        """Waits for the copies of one :meth:`out` (and the side stream's
        work before them) before anything is sent."""
        for ev in staged:
            ev.synchronize()

    def buffer(self, shape, dtype, device: torch.device) -> torch.Tensor:
        """A receive buffer for a tensor bound for ``device``."""
        if self.staged and device.type == "cuda":
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=device)

    def into(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """A received tensor on ``device`` (copied on the current stream)."""
        return t.to(device, non_blocking=True)


def _owned_stack(blocks: list, owners: list) -> torch.Tensor:
    """This rank's blocks stacked and zero-padded to the most parts a rank
    holds: the one shape an ``all_gather`` takes from every rank."""
    width = max(owners.count(r) for r in set(owners))
    return torch.stack(
        blocks + [torch.zeros_like(blocks[0])] * (width - len(blocks)))


def _all_gather_owned(mine: torch.Tensor, owners: list,
                      wire: Wire) -> tuple:
    """Every rank's ``mine`` (:func:`_owned_stack`, as it is sent) in one
    ``all_gather`` that every rank enters: (the blocks in global part
    order, the bytes this rank sent to each other rank).  The blocks come
    back on the host when ``wire`` stages."""
    got = [wire.buffer(mine.shape, mine.dtype, mine.device)
           for _ in range(dist.get_world_size())]
    dist.all_gather(got, mine)
    seen = [0] * len(got)
    out = []
    for r in owners:
        out.append(got[r][seen[r]])
        seen[r] += 1
    return out, mine.numel() * mine.element_size()


def _gather_owned(blocks: list, owners: list, wire: Wire) -> tuple:
    """Every part's block from every rank, ``blocks`` this rank's (its
    parts', in order): (the blocks in global part order, the bytes this
    rank sent to each other rank), staged and gathered at once."""
    (mine,), staged = wire.out(lambda: [_owned_stack(blocks, owners)],
                               blocks)
    wire.ready(staged)
    return _all_gather_owned(mine, owners, wire)


class ProcessHaloFill:
    """The halo fill of parts spread over processes: ``xs`` holds this
    rank's parts (``local``, global part ids, in order).  Two phases, as
    :class:`HaloFill`: :meth:`start` takes what leaves this rank (staged
    on a side stream, :meth:`Wire.out`) and the slabs that stay in it;
    :meth:`finish` waits for the staging only, sends and receives, and
    writes every halo column on the current stream.  A call does both.

    * ppermute: each slab of :func:`exchange_pairs` whose two parts share
      this process stays an index op (:func:`_take_nbr`); a slab
      across processes is sent by the owner of q, ``xs[q].index_select(-1,
      send_cols)``, and received by the owner of p into a buffer of that
      shape, then ``index_copy_``-ed into its halo columns.  All the
      cross-process ops of one fill go in one ``batch_isend_irecv``, tagged
      by their place in the list of cross-process slabs, which every rank
      derives alike;
    * allgather: every rank's owned blocks (``[.., H:H+B]`` of each of its
      parts) in one ``all_gather`` (:func:`_all_gather_owned`), then each
      part's halo columns taken from them, as :class:`HaloFill` does.

    ``owners[p]`` is the rank of part p, ``devices`` this rank's parts'
    devices.  ``messages`` and ``nbytes`` count what this rank sent since
    they were last set to 0: one message a slab (a rank) a fill, whatever
    the leading axes of ``xs`` (both limiter factors, tracers)."""

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

    def start(self, xs: list) -> tuple:
        H, B = self.H, self.B
        if self.mode == "allgather":
            blocks = [x[..., H:H + B] for x in xs]
            (mine,), staged = self.wire.out(
                lambda: [_owned_stack(blocks, self.owners)], xs)
            return xs, mine, staged
        slabs, staged = self.wire.out(
            lambda: [xs[i].index_select(-1, cols)
                     for _, _, i, cols in self.sends], xs)
        return xs, _take_nbr(xs, self.smaps), slabs, staged

    def finish(self, pending: tuple) -> list:
        if self.mode == "allgather":
            return self._finish_allgather(*pending)
        xs, taken, slabs, staged = pending
        self.wire.ready(staged)
        ops = [dist.P2POp(dist.isend, t, dst, tag=tag)
               for (tag, dst, _, _), t in zip(self.sends, slabs)]
        bufs = []
        for tag, src, i, cols in self.recvs:
            x = xs[i]
            buf = self.wire.buffer(x.shape[:-1] + (len(cols),), x.dtype,
                                   x.device)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        _place(xs, taken)
        for req in reqs:
            req.wait()
        for (_, _, i, cols), buf in zip(self.recvs, bufs):
            x = xs[i]
            x.index_copy_(x.dim() - 1, cols, self.wire.into(buf, x.device))
        self.messages += len(slabs)
        self.nbytes += sum(t.numel() * t.element_size() for t in slabs)
        return xs

    def __call__(self, xs: list) -> list:
        return self.finish(self.start(xs))

    def _finish_allgather(self, xs: list, mine: torch.Tensor,
                          staged: list) -> list:
        self.wire.ready(staged)
        blocks, sent = _all_gather_owned(mine, self.owners, self.wire)
        every = torch.cat(blocks, dim=-1)
        _place(xs, _take_allgather(xs, self.hmaps,
                                   lambda d: self.wire.into(every, d)))
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
    ``sharded_fct_ale_step``, phase by phase over the parts): both limiter
    factors stacked and their one exchange started, b3 vertical on the
    pre-exchange factors (node-local, owned columns final) while it is in
    flight, as the reference's inter_comm phase runs while MPI completes,
    then the exchange finished and b3 horizontal on the exchanged
    factors: the phases of ``model.fct_ale.PHASES["torch"]``, which one
    part whose exchange is its host's runs too (``host_embed``)."""
    parts = list(zip(mds, states))
    lims = [single.pre_exchange(md, cfg, s) for md, s in parts]
    pending = halo_fill.start([
        kernels.factor_pair(lim["fct_plus"], lim["fct_minus"])
        for lim in lims])
    verts = [single.limit_vertical(md, cfg, s, lim)
             for (md, s), lim in zip(parts, lims)]
    halo_fill.finish(pending)
    outs = [single.post_exchange(md, cfg, s, lim, vert)
            for (md, s), lim, vert in zip(parts, lims, verts)]
    if cfg.iter_yn:
        halo_fill([o["fct_LO"] for o in outs])
    return outs


def sharded_fct_ale_step_cuda(mds: list, cfg: FctAleConfig, halo_fill,
                              states: list, owned: tuple | None) -> list:
    """One step of the CUDA kernels on every part: split mode when
    ``owned`` (the owned columns (H, H + B), the same on every part) is
    given, fused mode when it is None.  Order, each phase over all parts,
    as the JAX package's split step (``ops/pallas/step.py``, the stacked
    ``pm`` exchanged once): K1, K2 -> start of the one exchange of both
    limiter factors (``kernels.factor_pair``, a view) -> [K3, on the
    pre-exchange factors, while the exchange is in flight] -> finish of
    the exchange (the halo columns written) -> K4-fix | K34 -> [fct_LO
    exchange].  A batched state (per-tracer fields [Tb, ...]) takes the
    same launches and exchanges, each over every tracer."""
    parts = list(zip(mds, states))
    pres = [cstep.pre_exchange(md, cfg, s) for md, s in parts]
    pending = halo_fill.start([
        kernels.factor_pair(pre["fct_plus"], pre["fct_minus"])
        for pre in pres])
    if owned is None:
        halo_fill.finish(pending)
        outs = [cstep.post_exchange_fused(md, cfg, s, pre)
                for (md, s), pre in zip(parts, pres)]
    else:
        edges = [cstep.limit_edges(md, cfg, s, pre)
                 for (md, s), pre in zip(parts, pres)]
        halo_fill.finish(pending)
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
            self.halo_fill = HaloFill(pm, exchange, self.devices)
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
