"""PyTorch port: the copied numpy mesh layers (RCM ordering, the cylinder
generator, the FESOM2 mesh-file reader and writer, the byte models)
against the JAX originals, and the FCT step on the orderings where the
JAX package runs its one-hot Pallas kernels.

The copies must give arrays equal to the originals.  The port's plain FCT
step is held to the JAX Pallas step in interpret mode on the RCM cylinder
and on ``tests/data/polar_cap`` (f32 relerr <= 2e-5, the bound of
tests/test_packed.py) and to the numpy oracle in f64 (1e-12).  H-K1's
plain version ``bounds_ref`` is bit-exact against the one-hot and the
BlockSpec-window DIA forms of the Pallas K1."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fesom2_accelerate_tpu.config import FctAleConfig as JaxFctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.mesh import fesom_io as jax_fesom_io
from fesom2_accelerate_tpu.mesh import ordering as jax_ordering
from fesom2_accelerate_tpu.mesh.generate import (
    generate_cylinder_mesh as jax_cylinder_mesh,
)
from fesom2_accelerate_tpu.ops import oracle
from fesom2_accelerate_tpu.ops.pallas import kernels as pallas_kernels
from fesom2_accelerate_tpu.ops.pallas.step import (
    _dia_rems,
    build_pallas_data,
    fct_ale_step_pallas,
)
from fesom2_accelerate_tpu.runtime import profiling as jax_profiling
from fesom2_accelerate_tpu_torch import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import (
    fesom_io,
    generate_cylinder_mesh,
    generate_planar_mesh,
    ordering,
    random_fields,
    read_fesom_mesh,
    write_fesom_mesh,
)
from fesom2_accelerate_tpu_torch.model.fct_ale import fct_ale_step
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.cuda.step import fct_ale_step_cuda
from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data
from fesom2_accelerate_tpu_torch.runtime import profiling

from conftest import masked_allclose

POLAR_CAP = os.path.join(os.path.dirname(__file__), "data", "polar_cap")
F32_RELERR = 2e-5  # tests/test_packed.py:143-147

# meshes on which the JAX Pallas step takes its one-hot K1 and K2
RCM_MESHES = {
    "cylinder": (lambda: generate_cylinder_mesh(48, 16, 8)[0],
                 lambda: jax_cylinder_mesh(48, 16, 8)[0]),
    "polar_cap": (lambda: read_fesom_mesh(POLAR_CAP)[0],
                  lambda: jax_fesom_io.read_fesom_mesh(POLAR_CAP)[0]),
}


def _relerr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def assert_same_mesh(ours, ref):
    ours.validate()
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("reorder", [True, False])
def test_cylinder_mesh_matches_jax(reorder):
    ours, perm = generate_cylinder_mesh(24, 10, 6, reorder=reorder)
    ref, jperm = jax_cylinder_mesh(24, 10, 6, reorder=reorder)
    assert_same_mesh(ours, ref)
    if reorder:
        np.testing.assert_array_equal(perm, jperm)
    else:
        assert perm is None and jperm is None


@pytest.mark.parametrize("name", ["small", "cylinder_raw"])
def test_rcm_order_and_reorder_match_jax(name):
    if name == "small":
        ours, ref = (generate_planar_mesh(preset="small"),
                     jax_planar_mesh(preset="small"))
    else:
        ours = generate_cylinder_mesh(20, 12, 6, reorder=False)[0]
        ref = jax_cylinder_mesh(20, 12, 6, reorder=False)[0]
    perm = ordering.rcm_order(ours)
    np.testing.assert_array_equal(perm, jax_ordering.rcm_order(ref))
    new, p = ordering.reorder_mesh(ours)
    jnew, jp = jax_ordering.reorder_mesh(ref)
    np.testing.assert_array_equal(p, jp)
    assert_same_mesh(new, jnew)
    assert ordering.bandwidth(new) == jax_ordering.bandwidth(jnew)
    if name == "cylinder_raw":
        # RCM absorbs the periodic seam (ids ~N apart in raw numbering)
        assert ordering.bandwidth(new) < ordering.bandwidth(ours) // 4


def test_rcb_and_halo_fraction_match_jax():
    ours = generate_cylinder_mesh(20, 12, 6)[0]
    ref = jax_cylinder_mesh(20, 12, 6)[0]
    perm, counts = ordering.rcb_order(ours, 4)
    jperm, jcounts = jax_ordering.rcb_order(ref, 4)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(counts, jcounts)
    owner = np.repeat(np.arange(4), counts)[np.argsort(perm)]
    assert ordering.halo_fraction(ours, owner, 4) == \
        jax_ordering.halo_fraction(ref, owner, 4)


@pytest.mark.parametrize("reorder", [True, False])
def test_read_fesom_mesh_matches_jax(reorder):
    """polar_cap: comment headers, shuffled ids, boundary flags,
    positive-down depths, CRLF line ends."""
    ours, perm = read_fesom_mesh(POLAR_CAP, reorder=reorder)
    ref, jperm = jax_fesom_io.read_fesom_mesh(POLAR_CAP, reorder=reorder)
    assert ours.n_nodes == 631
    assert_same_mesh(ours, ref)
    if reorder:
        np.testing.assert_array_equal(perm, jperm)
    else:
        assert perm is None and jperm is None


def test_write_fesom_mesh_matches_jax(tmp_path):
    """The port writes the same files, byte for byte, and reads them back
    to the mesh it wrote."""
    mesh = generate_planar_mesh(preset="tiny")
    write_fesom_mesh(str(tmp_path / "ours"), mesh)
    jax_fesom_io.write_fesom_mesh(str(tmp_path / "ref"),
                                  jax_planar_mesh(preset="tiny"))
    for f in ("nod2d.out", "elem2d.out", "aux3d.out"):
        assert (tmp_path / "ours" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f
    back, _ = read_fesom_mesh(str(tmp_path / "ours"), reorder=False)
    np.testing.assert_array_equal(back.elem_nodes, mesh.elem_nodes)
    np.testing.assert_array_equal(back.nlev_nod, mesh.nlev_nod)
    assert fesom_io._read_table(str(tmp_path / "ours" / "aux3d.out")) == \
        jax_fesom_io._read_table(str(tmp_path / "ref" / "aux3d.out"))


@pytest.mark.parametrize("name", ["small", "polar_cap"])
def test_byte_models_match_jax(name):
    if name == "small":
        ours, ref = (generate_planar_mesh(preset="small"),
                     jax_planar_mesh(preset="small"))
    else:
        ours, ref = (read_fesom_mesh(POLAR_CAP)[0],
                     jax_fesom_io.read_fesom_mesh(POLAR_CAP)[0])
    assert profiling.grid_points(ours) == jax_profiling.grid_points(ref)
    for itemsize in (4, 8):
        assert profiling.stress2rhs_bytes(ours, itemsize) == \
            jax_profiling.stress2rhs_bytes(ref, itemsize)
        for iter_yn in (False, True):
            assert profiling.fct_ale_step_bytes(ours, itemsize, iter_yn) == \
                jax_profiling.fct_ale_step_bytes(ref, itemsize, iter_yn)


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("name", list(RCM_MESHES))
def test_plain_step_matches_onehot_pallas_step(name, iter_yn):
    """The port's plain step (and ``fct_ale_step_cuda``, which runs the
    kernels' plain versions on CPU tensors) against the JAX Pallas step in
    interpret mode, which takes the one-hot K1 and K2 on these orderings,
    f32."""
    ours, ref = RCM_MESHES[name]
    mesh, jmesh = ours(), ref()
    pd, ps = build_pallas_data(jmesh)
    assert ps.pack_K == 0 and ps.a3f_dia_D == 0, \
        f"{name} must take the one-hot bounds_pallas / limit_pallas"
    fields = random_fields(mesh, seed=4, dtype=np.float32)
    jcfg = JaxFctAleConfig(dt=0.5, iter_yn=iter_yn, dtype=jnp.float32,
                           flux_eps=1e-7)
    with pltpu.force_tpu_interpret_mode():
        jout = fct_ale_step_pallas(pd, ps, jcfg, {
            k: jnp.asarray(v) for k, v in fields.items()})
    cfg = FctAleConfig(dt=0.5, iter_yn=iter_yn, flux_eps=1e-7,
                       dtype=torch.float32)
    md = build_mesh_data(mesh, torch.float32, "cpu")
    state = {k: torch.from_numpy(v) for k, v in fields.items()}
    for step in (fct_ale_step, fct_ale_step_cuda):
        out = step(md, cfg, state)
        for k in jout:
            err = _relerr(out[k].numpy(), jout[k])
            assert err <= F32_RELERR, f"{step.__name__}[{k}]: {err:.2e}"


@pytest.mark.parametrize("vlimit", [1, 2, 3])
@pytest.mark.parametrize("name", list(RCM_MESHES))
def test_plain_step_matches_oracle_f64(name, vlimit):
    ours, ref = RCM_MESHES[name]
    mesh, jmesh = ours(), ref()
    fields = random_fields(mesh, seed=6)
    md = build_mesh_data(mesh, torch.float64, "cpu")
    cfg = FctAleConfig(vlimit=vlimit, dt=0.6, dtype=torch.float64)
    want = oracle.fct_ale_step(jmesh, fields, vlimit=vlimit, dt=0.6)
    state = {k: torch.from_numpy(v) for k, v in fields.items()}
    for step in (fct_ale_step, fct_ale_step_cuda):
        out = step(md, cfg, state)
        for k, v in want.items():
            masked_allclose(out[k].numpy(), v, msg=f"{step.__name__}[{k}]")


@pytest.mark.parametrize("vlimit", [1, 2, 3])
@pytest.mark.parametrize("name", ["small", "cylinder"])
def test_bounds_ref_bit_exact_vs_pallas_k1_forms(name, vlimit):
    """bounds_ref against the one-hot K1 (bounds_pallas) on both meshes and
    the BlockSpec-window DIA K1 (bounds_dia_pallas) on the planar mesh,
    called as tests/test_pallas.py calls them: bit-exact, f32."""
    if name == "small":
        mesh, jmesh = (generate_planar_mesh(preset="small"),
                       jax_planar_mesh(preset="small"))
    else:
        mesh, jmesh = (generate_cylinder_mesh(48, 16, 8)[0],
                       jax_cylinder_mesh(48, 16, 8)[0])
    pd, ps = build_pallas_data(jmesh)
    assert bool(ps.a3f_dia_D) == (name == "small")
    fields = random_fields(mesh, seed=5, dtype=np.float32)
    L, N, Lp = ps.L, ps.N, ps.Lp
    lo = np.zeros((Lp, ps.Np), np.float32)
    tt = np.zeros((Lp, ps.Np), np.float32)
    lo[:L, :N] = fields["fct_LO"]
    tt[:L, :N] = fields["ttf"]
    with pltpu.force_tpu_interpret_mode():
        outs = {"onehot": pallas_kernels.bounds_pallas(
            jnp.asarray(lo), jnp.asarray(tt), pd.a3f_lidx_lo, pd.a3f_lev_lo,
            pd.a3f_lidx_hi, pd.a3f_lev_hi, pd.a3f_wb, pd.nlev_nod_row,
            tile=ps.tile, nblocks_lo=ps.a3f_lo_nblocks,
            nblocks_hi=ps.a3f_hi_nblocks, K_lo=ps.K_lo, K_hi=ps.K_hi,
            vlimit=vlimit, chunk=ps.chunk)}
        if ps.a3f_dia_D:
            outs["dia"] = pallas_kernels.bounds_dia_pallas(
                jnp.asarray(lo), jnp.asarray(tt), pd.a3f_dia_wb,
                pd.a3f_dia_lev, pd.nlev_nod_row, tile=ps.tile,
                nblocks=ps.a3f_un_nblocks, D=ps.a3f_dia_D,
                rems=_dia_rems(ps), vlimit=vlimit)
    md = build_mesh_data(mesh, torch.float32, "cpu")
    tmax, tmin = kernels.bounds_ref(md, torch.from_numpy(fields["fct_LO"]),
                                    torch.from_numpy(fields["ttf"]), vlimit)
    for form, out in outs.items():
        out = np.asarray(out)
        np.testing.assert_array_equal(tmax.numpy(), out[:L, :N],
                                      err_msg=f"{form} fct_ttf_max")
        np.testing.assert_array_equal(tmin.numpy(), out[Lp:Lp + L, :N],
                                      err_msg=f"{form} fct_ttf_min")
