"""PyTorch port: the copied numpy partitioner against the JAX original, the
scatter/gather round trips, the exact fix-edge lists of the split sharded
step, and the rule by which H-K34 writes each edge output once on every
part of a partitioned mesh.

H-K34 is node-threaded: each edge output is written from one incidence
slot, the one ``MeshData.nd_wrt`` marks.  The rule of the first port wrote
from the edge's first endpoint only; on a part the incidence rows of halo
nodes are empty, so every edge from a low-side halo node to an owned node
had no writer (31 per interior part of ``small`` at 8 parts, 605 per
interior part of core2 at 4).  The CUDA kernel runs only on a GPU; here
the writer slots it reads are counted."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.mesh import ordering as jax_ordering
from fesom2_accelerate_tpu.mesh.generate import (
    generate_cylinder_mesh as jax_cylinder_mesh,
)
from fesom2_accelerate_tpu.ops.meshdata import build_mesh_data as jax_mesh_data
from fesom2_accelerate_tpu.parallel import partition as jax_partition
from fesom2_accelerate_tpu_torch.mesh import (
    generate_cylinder_mesh,
    generate_planar_mesh,
    ordering,
    random_fields,
)
from fesom2_accelerate_tpu_torch.ops.meshdata import (
    MeshData,
    build_mesh_data,
    mesh_data_from_numpy,
)
from fesom2_accelerate_tpu_torch.parallel import partition as part_mod
from fesom2_accelerate_tpu_torch.parallel import partition_mesh
from fesom2_accelerate_tpu_torch.parallel.step_sharded import fix_edge_ids


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


@pytest.mark.parametrize("case", ["small-8", "multihop-8", "cylinder-rcb-4",
                                  "core2-4"])
def test_writer_slots_cover_every_real_local_edge_once(case):
    """On each part's MeshData, the slots H-K34 writes from (``nd_wrt``)
    cover every real local edge exactly once, and the edges of no slot
    (``ed_free``, passed through by the kernel) are exactly the padding.
    The first endpoint alone, the rule before the repair, leaves the edges
    whose first endpoint is a low-side halo node unwritten."""
    if case == "core2-4":
        pm = partition_mesh(generate_planar_mesh(preset="core2"), 4)
    else:
        pm = _build(case)[0]
    for p, mesh in enumerate(pm.local_meshes):
        md = build_mesh_data(mesh, torch.float32, "cpu")
        n_real = _real_edges(pm, p)
        idx = md.nd_idx.numpy()
        writes = np.bincount(idx[md.nd_wrt.numpy() != 0],
                             minlength=md.n_edges)
        assert (writes[:n_real] == 1).all(), f"part {p}"
        assert (writes[n_real:] == 0).all(), f"part {p}"
        np.testing.assert_array_equal(md.ed_free.numpy(),
                                      np.arange(n_real, md.n_edges))
        assert bool((md.nd_wrt.bool() <= md.nd_k).all())

        first_only = np.bincount(idx[md.nd_sgn.numpy() > 0],
                                 minlength=md.n_edges)
        low_halo_first = mesh.edges[:n_real, 0] < pm.H
        np.testing.assert_array_equal(first_only[:n_real] == 0,
                                      low_halo_first)
        if case == "small-8" and 0 < p < pm.n_parts - 1:
            assert low_halo_first.sum() == 31
        if case == "core2-4" and 0 < p < pm.n_parts - 1:
            assert low_halo_first.sum() == 605
    assert low_halo_first.any(), "the last part has a low-side halo"


@pytest.mark.parametrize("name", ["small", "cylinder"])
def test_writer_slots_on_a_whole_mesh_are_the_first_endpoints(name):
    """On a whole mesh the rule is the first port's (first endpoint writes,
    no free edge), so single-device H-K34 outputs are unchanged."""
    mesh = (generate_planar_mesh(preset="small") if name == "small"
            else generate_cylinder_mesh(24, 10, 6)[0])
    md = build_mesh_data(mesh, torch.float64, "cpu")
    assert torch.equal(md.nd_wrt.bool(), md.nd_sgn > 0)
    assert md.ed_free.numel() == 0
    assert torch.equal(md.nlev_edge, torch.from_numpy(mesh.nlev_edge))


def test_mesh_data_from_numpy_on_parts():
    """The JAX MeshData of each part, carried across as numpy, is the
    port's MeshData of the same part, the writer slots and free edges
    included."""
    pm, jpm = _build("small-8")
    for p in range(pm.n_parts):
        jmd = jax_mesh_data(jpm.local_meshes[p], dtype=jnp.float64)
        got = mesh_data_from_numpy(
            {f.name: np.asarray(getattr(jmd, f.name))
             for f in dataclasses.fields(jmd)}, "cpu")
        ref = build_mesh_data(pm.local_meshes[p], torch.float64, "cpu")
        for f in dataclasses.fields(MeshData):
            assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), \
                f"part {p}: {f.name}"


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
