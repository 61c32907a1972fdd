"""PyTorch port: the copied numpy partitioner against the JAX original, the
scatter/gather round trips, the exact fix-edge lists of the split sharded
step, and the edge ranges by which H-K34 writes each edge output once, on
whole meshes and on every part of a partitioned mesh; a mesh whose edges
are in another order runs everywhere but H-K34.

H-K34 writes each edge output from the block of the node tile in which the
edge starts: the range ``MeshData.ed_ptr[n0] .. ed_ptr[n1]`` of a tile of
``TILE_NODES`` nodes, the last tile also taking a part's padding edges.  On
a part the incidence rows of halo nodes are empty, and the edges from a
low-side halo column to an owned node (31 per interior part of ``small``
at 8 parts, 605 per interior part of core2 at 4) are the ones a rule tied
to incidence rows once left unwritten.  The CUDA kernel runs only on a GPU;
here the ranges it reads are checked."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.config import FctAleConfig as JaxConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.mesh import ordering as jax_ordering
from fesom2_accelerate_tpu.mesh.generate import (
    generate_cylinder_mesh as jax_cylinder_mesh,
)
from fesom2_accelerate_tpu.mesh.topology import Mesh as JaxMesh
from fesom2_accelerate_tpu.model.fct_ale import fct_ale_step as jax_fct_ale_step
from fesom2_accelerate_tpu.ops.meshdata import build_mesh_data as jax_mesh_data
from fesom2_accelerate_tpu.parallel import partition as jax_partition
from fesom2_accelerate_tpu_torch import (
    FctAleConfig,
    FctAleSolver,
    Stress2RhsSolver,
)
from fesom2_accelerate_tpu_torch.mesh import (
    generate_cylinder_mesh,
    generate_planar_mesh,
    ordering,
    random_fields,
)
from fesom2_accelerate_tpu_torch.mesh.fesom_io import read_fesom_mesh
from fesom2_accelerate_tpu_torch.ops.meshdata import (
    TILE_NODES,
    MeshData,
    build_mesh_data,
    mesh_data_from_numpy,
)
from fesom2_accelerate_tpu_torch.parallel import partition as part_mod
from fesom2_accelerate_tpu_torch.parallel import partition_mesh
from fesom2_accelerate_tpu_torch.parallel.step_sharded import fix_edge_ids

from conftest import masked_allclose

POLAR_CAP = os.path.join(os.path.dirname(__file__), "data", "polar_cap")


def _rcb(mesh_fn, order_mod, n_parts):
    mesh = mesh_fn()
    perm, counts = order_mod.rcb_order(mesh, n_parts)
    return order_mod.reorder_mesh(mesh, perm)[0], counts


# (port mesh, JAX mesh, parts, RCB counts or None)
CASES = {
    "small-4": (lambda: generate_planar_mesh(preset="small"),
                lambda: jax_planar_mesh(preset="small"), 4),
    "small-8": (lambda: generate_planar_mesh(preset="small"),
                lambda: jax_planar_mesh(preset="small"), 8),
    "multihop-8": (lambda: generate_planar_mesh(nx=4, ny=7, nl=5),
                   lambda: jax_planar_mesh(nx=4, ny=7, nl=5), 8),
    "cylinder-rcb-4": (
        lambda: _rcb(lambda: generate_cylinder_mesh(20, 12, 6)[0], ordering,
                     4),
        lambda: _rcb(lambda: jax_cylinder_mesh(20, 12, 6)[0], jax_ordering,
                     4), 4),
}


def _build(case):
    ours_fn, ref_fn, n_parts = CASES[case]
    ours, ref = ours_fn(), ref_fn()
    counts = jcounts = None
    if isinstance(ours, tuple):
        (ours, counts), (ref, jcounts) = ours, ref
        np.testing.assert_array_equal(counts, jcounts)
    return (part_mod.partition_mesh(ours, n_parts, counts=counts),
            jax_partition.partition_mesh(ref, n_parts, counts=jcounts))


def _assert_equal(a, b, name):
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    elif isinstance(b, list):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{name}[{i}]")
    elif dataclasses.is_dataclass(b):
        for f in dataclasses.fields(b):
            _assert_equal(getattr(a, f.name), getattr(b, f.name),
                          f"{name}.{f.name}")
    else:
        assert a == b, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_matches_jax(case):
    """Every array of the port's PartitionedMesh, the local meshes and the
    per-hop send lists included, equals the JAX package's."""
    pm, jpm = _build(case)
    _assert_equal(pm, jpm, "pm")
    if case == "multihop-8":
        assert pm.neighbor_radius >= 2
    assert pm.n_local == jpm.n_local and pm.owned_off == jpm.owned_off


@pytest.mark.parametrize("kind", ["node", "interface", "edge"])
def test_scatter_gather_roundtrip(kind):
    mesh = generate_planar_mesh(preset="small")
    fields = random_fields(mesh, seed=3)
    pm = partition_mesh(mesh, 4)
    jpm = jax_partition.partition_mesh(jax_planar_mesh(preset="small"), 4)
    key = {"node": "ttf", "interface": "fct_adf_v", "edge": "fct_adf_h"}[kind]
    scatter, gather = ((part_mod.scatter_edge_field, part_mod.gather_edge_field)
                       if kind == "edge" else
                       (part_mod.scatter_node_field,
                        part_mod.gather_node_field))
    loc = scatter(pm, fields[key])
    jscatter = (jax_partition.scatter_edge_field if kind == "edge"
                else jax_partition.scatter_node_field)
    np.testing.assert_array_equal(loc, jscatter(jpm, fields[key]))
    np.testing.assert_array_equal(gather(pm, loc), fields[key])


def _real_edges(pm, p):
    return int(np.sum(pm.local_edges_global[p] >= 0))


def _assert_tile_ranges(mesh, md, n_real):
    """The tiles' edge ranges of H-K34 on one mesh (or part) whose first
    ``n_real`` edges are real and the rest padding: they cover [0, Ed)
    exactly once, each real edge lies in the tile of its first endpoint,
    the padding is the last tile's tail, and ``md.tile_edges`` (the
    shared-memory rows the host sizes) holds every tile's real edges.
    Returns the real edges whose endpoints lie in two tiles."""
    ptr = md.ed_ptr.numpy().astype(np.int64)
    N, Ed = md.n_nodes, md.n_edges
    assert ptr.shape == (N + 1,) and ptr[0] == 0 and ptr[N] == n_real
    first, second = mesh.edges[:, 0], mesh.edges[:, 1]
    # ed_ptr[n]: the real edges whose first endpoint is below n
    np.testing.assert_array_equal(
        ptr, [(first[:n_real] < n).sum() for n in range(N + 1)])
    starts = np.arange(0, N, TILE_NODES)
    ends = np.minimum(starts + TILE_NODES, N)
    lo = ptr[starts]
    hi = np.where(ends == N, Ed, ptr[ends])  # the edges a block writes
    cover = np.zeros(Ed, np.int64)
    for a, b in zip(lo, hi):
        cover[a:b] += 1
    assert (cover == 1).all()
    tile = np.repeat(np.arange(len(starts)), hi - lo)
    np.testing.assert_array_equal(tile[:n_real],
                                  first[:n_real] // TILE_NODES)
    assert (mesh.nlev_edge[n_real:] == 0).all()
    assert (first[n_real:] == second[n_real:]).all()

    assert md.tile_edges == int((ptr[ends] - ptr[starts]).max())
    # the edges a tile's nodes hold in their rows but do not write: each
    # starts in an earlier tile, and the kernel limits it again
    crossing = first[:n_real] // TILE_NODES != second[:n_real] // TILE_NODES
    return int(crossing.sum())


@pytest.mark.parametrize("name", ["small", "cylinder", "polar_cap",
                                  "polar_cap_raw"])
def test_edge_ranges_cover_a_whole_mesh(name):
    """Whole meshes: planar, RCM cylinder (16-slot rows), and the FESOM2
    mesh files of polar_cap, RCM-renumbered and in their own numbering."""
    mesh = {"small": lambda: generate_planar_mesh(preset="small"),
            "cylinder": lambda: generate_cylinder_mesh(24, 10, 6)[0],
            "polar_cap": lambda: read_fesom_mesh(POLAR_CAP)[0],
            "polar_cap_raw": lambda: read_fesom_mesh(POLAR_CAP,
                                                     reorder=False)[0],
            }[name]()
    md = build_mesh_data(mesh, torch.float64, "cpu")
    assert _assert_tile_ranges(mesh, md, mesh.n_edges) > 0, \
        "some edges cross a tile boundary"
    assert torch.equal(md.nlev_edge, torch.from_numpy(mesh.nlev_edge))


@pytest.mark.parametrize("case", ["small-4", "small-8", "core2-4",
                                  "multihop-8", "cylinder-rcb-4"])
def test_edge_ranges_cover_every_part(case):
    """Every part: the tile of a low-side halo column writes the edges
    from it to owned nodes, and the padding passes through the last
    tile."""
    if case == "core2-4":
        pm = partition_mesh(generate_planar_mesh(preset="core2"), 4)
    else:
        pm = _build(case)[0]
    for p, mesh in enumerate(pm.local_meshes):
        md = build_mesh_data(mesh, torch.float32, "cpu")
        n_real = _real_edges(pm, p)
        _assert_tile_ranges(mesh, md, n_real)
        low_halo_first = mesh.edges[:n_real, 0] < pm.H
        if case == "small-8" and 0 < p < pm.n_parts - 1:
            assert low_halo_first.sum() == 31
        if case == "core2-4" and 0 < p < pm.n_parts - 1:
            assert low_halo_first.sum() == 605
    assert low_halo_first.any(), "the last part has a low-side halo"


def test_edge_ptr_refuses_edges_out_of_order():
    """ed_ptr needs the edges sorted by first endpoint, oriented n0 < n1,
    padding last.  Mesh data of any other order builds (only H-K34 reads
    ed_ptr); reading its ed_ptr, or its tile_edges, raises."""
    mesh = generate_planar_mesh(preset="toy")
    for bad in (mesh.edges[::-1], mesh.edges[:, ::-1],
                np.concatenate([[[0, 0]], mesh.edges[1:]])):
        md = build_mesh_data(dataclasses.replace(
            mesh, edges=np.ascontiguousarray(bad)), torch.float32, "cpu")
        assert md.n_edges == mesh.n_edges
        with pytest.raises(ValueError, match="sorted"):
            md.ed_ptr
        with pytest.raises(ValueError, match="sorted"):
            md.tile_edges


def _permute_edges(mesh, seed: int):
    """The same mesh with its edges in a random order and every third one
    reversed: ``edges``, ``edge_tri`` and ``nlev_edge`` permuted,
    ``node_edges`` remapped through the inverse permutation (each node keeps
    its slot order) and ``node_edges_sign`` flipped where an edge is
    reversed.  Returns (mesh, permutation, reversed): new edge i is old
    edge perm[i]."""
    Ed = mesh.n_edges
    perm = np.random.default_rng(seed).permutation(Ed)
    inv = np.empty(Ed, np.int64)
    inv[perm] = np.arange(Ed)
    rev = np.zeros(Ed, bool)
    rev[::3] = True
    edges = mesh.edges[perm].copy()
    edges[rev] = edges[rev, ::-1]
    live = mesh.node_edges >= 0
    node_edges = np.where(live, inv[np.where(live, mesh.node_edges, 0)], -1)
    sign = np.where(live & rev[np.where(live, node_edges, 0)],
                    -mesh.node_edges_sign, mesh.node_edges_sign)
    return dataclasses.replace(
        mesh, edges=edges, edge_tri=mesh.edge_tri[perm].copy(),
        nlev_edge=mesh.nlev_edge[perm].copy(),
        node_edges=node_edges.astype(mesh.node_edges.dtype),
        node_edges_sign=sign.astype(mesh.node_edges_sign.dtype)), perm, rev


@pytest.mark.parametrize("iter_yn", [False, True])
def test_unsorted_edges_run_on_torch_backend_and_stress2rhs(iter_yn):
    """A consistent edge-permuted mesh: FctAleSolver(backend="torch") runs
    on it and matches the JAX XLA step on the same mesh (f64, 1e-12), and
    the step on the sorted mesh with its edge fluxes carried along (the
    same physics); Stress2RhsSolver(backend="torch"), which reads no edges,
    gives the sorted mesh's bits.  Only H-K34's ed_ptr refuses the mesh."""
    mesh = generate_planar_mesh(preset="small")
    pmesh, perm, rev = _permute_edges(mesh, seed=4)
    pmesh.validate()
    assert not (np.diff(pmesh.edges[:, 0]) >= 0).all()
    fields = random_fields(mesh, seed=8)
    pfields = dict(fields)
    pfields["fct_adf_h"] = np.where(rev, -1.0, 1.0) * fields["fct_adf_h"][
        :, perm]

    cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=torch.float64)
    solver = FctAleSolver(pmesh, cfg, backend="torch", device="cpu")
    with pytest.raises(ValueError, match="sorted"):
        solver.md.ed_ptr
    out = solver.step(solver.init_state(pfields))

    jmesh = JaxMesh(**{f.name: getattr(pmesh, f.name)
                       for f in dataclasses.fields(pmesh)})
    jmd = jax_mesh_data(jmesh, dtype=jnp.float64)
    jout = jax_fct_ale_step(
        jmd, JaxConfig(dt=0.7, iter_yn=iter_yn, dtype=jnp.float64),
        {k: jnp.asarray(v) for k, v in pfields.items()})
    assert out.keys() == jout.keys()
    for k, v in jout.items():
        masked_allclose(out[k].numpy(), np.asarray(v), msg=f"jax[{k}]")

    sorted_solver = FctAleSolver(mesh, cfg, backend="torch", device="cpu")
    ref = sorted_solver.step(sorted_solver.init_state(fields))
    for k, v in ref.items():
        want = v.numpy()
        if want.shape[-1] == mesh.n_edges:
            want = np.where(rev, -1.0, 1.0) * want[:, perm]
        masked_allclose(out[k].numpy(), want, msg=f"sorted[{k}]")

    rng = np.random.default_rng(2)
    E, N = mesh.n_elems, mesh.n_nodes
    args = [torch.from_numpy(a) for a in (
        np.abs(rng.standard_normal(E)) + 0.1, rng.standard_normal(E),
        *rng.standard_normal((3, E)), rng.standard_normal((6, E)),
        rng.standard_normal(E), rng.standard_normal(N),
        *rng.standard_normal((2, N)))]
    got = Stress2RhsSolver(pmesh, torch.float64, backend="torch",
                           device="cpu")(*args)
    want = Stress2RhsSolver(mesh, torch.float64, backend="torch",
                            device="cpu")(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_mesh_data_from_numpy_on_parts():
    """The JAX MeshData of each part, carried across as numpy, is the
    port's MeshData of the same part, the edge ranges included."""
    pm, jpm = _build("small-8")
    for p in range(pm.n_parts):
        jmd = jax_mesh_data(jpm.local_meshes[p], dtype=jnp.float64)
        got = mesh_data_from_numpy(
            {f.name: np.asarray(getattr(jmd, f.name))
             for f in dataclasses.fields(jmd)}, "cpu")
        ref = build_mesh_data(pm.local_meshes[p], torch.float64, "cpu")
        for name in [f.name for f in dataclasses.fields(MeshData)] + [
                "ed_ptr"]:
            assert torch.equal(getattr(got, name), getattr(ref, name)), \
                f"part {p}: {name}"


@pytest.mark.parametrize("case", ["small-4", "small-8", "multihop-8"])
def test_fix_edge_ids_are_exact(case):
    """Each part's fix list holds each real local edge with an endpoint in a
    halo column once, in ascending order, and nothing else: every other
    real edge has both endpoints owned, and padding never appears."""
    pm = _build(case)[0]
    H, B = pm.H, pm.B
    for p, mesh in enumerate(pm.local_meshes):
        ids = fix_edge_ids(pm, p)
        assert ids.dtype == np.int32
        assert (np.diff(ids) > 0).all()
        n_real = _real_edges(pm, p)
        owned = (mesh.edges[:n_real] >= H) & (mesh.edges[:n_real] < H + B)
        np.testing.assert_array_equal(
            ids, np.nonzero(~owned.all(axis=1))[0])
        assert len(ids) > 0
