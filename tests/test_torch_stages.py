"""PyTorch port: mesh code, mesh data and every plain stage against the JAX
package, in float64, on the same numpy inputs (masked_allclose 1e-12)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.mesh import random_fields as jax_random_fields
from fesom2_accelerate_tpu.ops import stages as jax_stages
from fesom2_accelerate_tpu.ops.meshdata import build_mesh_data as jax_mesh_data
from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu_torch.ops import stages as torch_stages
from fesom2_accelerate_tpu_torch.ops.meshdata import (
    MeshData,
    build_mesh_data,
    mesh_data_from_numpy,
)

from conftest import masked_allclose

DT, EPS, BIG = 0.7, 1e-16, 1e3


@pytest.mark.parametrize("preset", ["toy", "tiny", "small"])
def test_mesh_copy_matches_jax_mesh(preset):
    """The port's copy of the numpy mesh code builds the same mesh and the
    same random fields as the JAX package."""
    ours = generate_planar_mesh(preset=preset)
    ref = jax_planar_mesh(preset=preset)
    ours.validate()
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    fa, fb = random_fields(ours, seed=4), jax_random_fields(ref, seed=4)
    assert fa.keys() == fb.keys()
    for k in fb:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_data_from_numpy_equals_build_mesh_data(dtype):
    """The JAX MeshData carried across as numpy is the port's own MeshData,
    field by field and exactly, including the rows the kernels read."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    jmd = jax_mesh_data(jax_planar_mesh(preset="small"), dtype=jdtype)
    arrays = {f.name: np.asarray(getattr(jmd, f.name))
              for f in dataclasses.fields(jmd)}
    got = mesh_data_from_numpy(arrays, "cpu")
    ref = build_mesh_data(generate_planar_mesh(preset="small"), dtype, "cpu")
    for f in dataclasses.fields(MeshData):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype, f.name
        assert torch.equal(a, b), f.name
    assert ref.nd_sgn.dtype == torch.int8
    assert int(ref.nd_num.sum()) == 2 * ref.n_edges
    assert bool(((ref.nd_sgn != 0) == ref.nd_k).all())


@pytest.fixture(scope="module")
def setup():
    """Meshes, mesh data and numpy stage inputs shared by both packages."""
    mesh = generate_planar_mesh(preset="small")
    fields = random_fields(mesh, seed=7)
    rng = np.random.default_rng(17)
    L, N, E = mesh.n_layers, mesh.n_nodes, mesh.n_elems
    node_mask = np.arange(L)[:, None] < mesh.nlev_nod[None, :] - 1
    x = dict(fields)
    x.update(
        rmax=rng.standard_normal((L, N)),
        rmin=rng.standard_normal((L, N)),
        UV_max=rng.standard_normal((L, E)),
        UV_min=rng.standard_normal((L, E)),
        a1max=np.where(node_mask, np.maximum(fields["fct_LO"],
                                             fields["ttf"]), 0.0),
        a1min=np.where(node_mask, np.minimum(fields["fct_LO"],
                                             fields["ttf"]), 0.0),
        pv=np.abs(rng.standard_normal((L, N))),
        mv=-np.abs(rng.standard_normal((L, N))),
        fac_p=rng.uniform(0.0, 1.0, (L, N)),
        fac_m=rng.uniform(0.0, 1.0, (L, N)),
        tmax=np.abs(rng.standard_normal((L, N))),
        tmin=-np.abs(rng.standard_normal((L, N))),
    )
    jmd = jax_mesh_data(jax_planar_mesh(preset="small"), dtype=jnp.float64)
    tmd = build_mesh_data(mesh, torch.float64, "cpu")
    return (jmd, {k: jnp.asarray(v) for k, v in x.items()},
            tmd, {k: torch.from_numpy(v) for k, v in x.items()})


# Each case calls one stage by the name both packages share, so the same
# call runs through the JAX stages and the port's stages.
CASES = {
    "a1": lambda s, md, x: s.a1(md, x["fct_LO"], x["ttf"]),
    "a2": lambda s, md, x: s.a2(md, x["rmax"], x["rmin"], BIG),
    "_cluster_reduce": lambda s, md, x: s._cluster_reduce(
        md, x["UV_max"], x["UV_min"]),
    "a3_vlimit1": lambda s, md, x: s.a3_vlimit1(
        md, x["UV_max"], x["UV_min"], x["fct_LO"]),
    "_a3_vlimit23_widen": lambda s, md, x: s._a3_vlimit23(
        md, x["UV_max"], x["UV_min"], x["rmax"], x["fct_LO"], widen=True),
    "_a3_vlimit23_narrow": lambda s, md, x: s._a3_vlimit23(
        md, x["UV_max"], x["UV_min"], x["rmax"], x["fct_LO"], widen=False),
    "a3_v1": lambda s, md, x: s.a3(md, x["UV_max"], x["UV_min"], x["rmax"],
                                   x["fct_LO"], 1),
    "a3_v2": lambda s, md, x: s.a3(md, x["UV_max"], x["UV_min"], x["rmax"],
                                   x["fct_LO"], 2),
    "a3_v3": lambda s, md, x: s.a3(md, x["UV_max"], x["UV_min"], x["rmax"],
                                   x["fct_LO"], 3),
    "_cluster_reduce_via_edges": lambda s, md, x: s._cluster_reduce_via_edges(
        md, x["a1max"], x["a1min"]),
    "a3_vlimit1_fused": lambda s, md, x: s.a3_vlimit1_fused(
        md, x["a1max"], x["a1min"], x["fct_LO"]),
    "b1_vertical": lambda s, md, x: s.b1_vertical(md, x["fct_adf_v"]),
    "b1_horizontal": lambda s, md, x: s.b1_horizontal(
        md, x["pv"], x["mv"], x["fct_adf_h"]),
    "b2": lambda s, md, x: s.b2(md, x["pv"], x["mv"], x["tmax"], x["tmin"],
                                DT, EPS),
    "b3_vertical": lambda s, md, x: s.b3_vertical(
        md, x["fac_p"], x["fac_m"], x["fct_adf_v"], False),
    "b3_vertical_iter": lambda s, md, x: s.b3_vertical(
        md, x["fac_p"], x["fac_m"], x["fct_adf_v"], True),
    "b3_horizontal": lambda s, md, x: s.b3_horizontal(
        md, x["fac_p"], x["fac_m"], x["fct_adf_h"], False),
    "b3_horizontal_iter": lambda s, md, x: s.b3_horizontal(
        md, x["fac_p"], x["fac_m"], x["fct_adf_h"], True),
    "edge_flux_to_nodes": lambda s, md, x: s.edge_flux_to_nodes(
        md, x["fct_adf_h"]),
    "c_update_solution": lambda s, md, x: s.c_update_solution(
        md, x["ttf"], x["hnode"], x["hnode_new"], x["fct_LO"],
        x["fct_adf_v"], x["fct_adf_h"], x["del_ttf_advvert"],
        x["del_ttf_advhoriz"], DT),
    "c_update_LO": lambda s, md, x: s.c_update_LO(
        md, x["fct_LO"], x["fct_adf_v"], x["fct_adf_h"], x["hnode_new"], DT),
}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_matches_jax(setup, case):
    jmd, jx, tmd, tx = setup
    ref = _outputs(CASES[case](jax_stages, jmd, jx))
    got = _outputs(CASES[case](torch_stages, tmd, tx))
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None, f"{case}[{i}]"
            continue
        assert a.dtype == torch.float64 and tuple(a.shape) == b.shape
        masked_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12,
                        msg=f"{case}[{i}]")
