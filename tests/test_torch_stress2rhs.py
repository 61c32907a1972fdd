"""PyTorch port: the sea-ice EVP stress2rhs workload against the JAX
package and its numpy oracle.

Inputs are made from numpy seeds as bench.py makes them, on three
orderings: the bandwidth-ordered planar ``small`` mesh, an RCM-ordered
cylinder and the FESOM2 mesh files of ``tests/data/polar_cap`` (RCM by
default).  Float64 is held to ``masked_allclose`` (rtol 1e-12); float32
to relerr <= 2e-6 against the JAX Pallas forms, run in TPU interpret mode
as tests/test_stages_xla.py runs them.  The H-S2R kernel itself runs only
on a GPU (``python3 chip_smoke.py``); here its wrapper runs its plain
version, ``stress2rhs_ref``, on CPU tensors."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.mesh.fesom_io import (
    read_fesom_mesh as jax_read_fesom_mesh,
)
from fesom2_accelerate_tpu.mesh.generate import (
    generate_cylinder_mesh as jax_cylinder_mesh,
)
from fesom2_accelerate_tpu.model.stress2rhs import (
    Stress2RhsSolver as JaxStress2RhsSolver,
)
from fesom2_accelerate_tpu.ops import oracle
from fesom2_accelerate_tpu_torch import Stress2RhsSolver
from fesom2_accelerate_tpu_torch.mesh import (
    generate_cylinder_mesh,
    generate_planar_mesh,
    read_fesom_mesh,
)
from fesom2_accelerate_tpu_torch.ops import stages
from fesom2_accelerate_tpu_torch.ops.cuda import build, kernels
from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data

from conftest import masked_allclose

POLAR_CAP = os.path.join(os.path.dirname(__file__), "data", "polar_cap")
F32_RELERR = 2e-6  # tests/test_stages_xla.py:150

MESHES = {
    "small": (lambda: generate_planar_mesh(preset="small"),
              lambda: jax_planar_mesh(preset="small")),
    "cylinder": (lambda: generate_cylinder_mesh(48, 16, 8)[0],
                 lambda: jax_cylinder_mesh(48, 16, 8)[0]),
    "polar_cap": (lambda: read_fesom_mesh(POLAR_CAP)[0],
                  lambda: jax_read_fesom_mesh(POLAR_CAP)[0]),
}


@pytest.fixture(scope="module", params=list(MESHES))
def case(request):
    """(name, port mesh, JAX mesh, numpy inputs) for each ordering."""
    ours, ref = MESHES[request.param]
    mesh = ours()
    return request.param, mesh, ref(), inputs(mesh)


def inputs(mesh, seed=7):
    """bench.py's stress2rhs inputs: elem_area, ice_strength, sigma11,
    sigma12, sigma22 [E], gradient_sca [6, E], metric_factor [E],
    inv_areamass, rhs_a, rhs_m [N]."""
    rng = np.random.default_rng(seed)
    E, N = mesh.n_elems, mesh.n_nodes
    return (np.abs(rng.standard_normal(E)) + 0.1, rng.standard_normal(E),
            *rng.standard_normal((3, E)), rng.standard_normal((6, E)),
            rng.standard_normal(E), rng.standard_normal(N),
            *rng.standard_normal((2, N)))


def _relerr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def test_f64_matches_jax_xla_and_oracle(case):
    name, mesh, jmesh, host = case
    U, V = Stress2RhsSolver(mesh, torch.float64, device="cpu")(*host)
    jU, jV = JaxStress2RhsSolver(jmesh, dtype=jnp.float64,
                                 backend="xla")(*host)
    rU, rV = oracle.stress2rhs(jmesh.elem_nodes, jmesh.node_elems,
                               jmesh.node_elems_pos, jmesh.node_elems_num,
                               *host)
    assert U.dtype == torch.float64 and U.shape == (mesh.n_nodes,)
    masked_allclose(U.numpy(), np.asarray(jU), msg=f"{name} U vs jax")
    masked_allclose(V.numpy(), np.asarray(jV), msg=f"{name} V vs jax")
    masked_allclose(U.numpy(), rU, msg=f"{name} U vs oracle")
    masked_allclose(V.numpy(), rV, msg=f"{name} V vs oracle")


def test_plain_kernel_matches_stages_gate(case):
    """stress2rhs_ref on the packed slab (the kernel's masks) against the
    gather form stages.stress2rhs, f64."""
    name, mesh, _, host = case
    solver = Stress2RhsSolver(mesh, torch.float64, device="cpu")
    slab = solver.pack_elem_inputs(*host[:7])
    assert slab.shape == (kernels.SLAB_ROWS, mesh.n_elems)
    node = [torch.from_numpy(a) for a in host[7:]]
    got = kernels.stress2rhs_ref(solver.md, slab, *node)
    ref = stages.stress2rhs(solver.md, *(torch.from_numpy(np.asarray(a))
                                         for a in host))
    for g, r, comp in zip(got, ref, "UV"):
        masked_allclose(g.numpy(), r.numpy(), msg=f"{name} {comp}")


@pytest.mark.parametrize("mesh_name,form,packed", [
    ("small", "packed", True),
    ("small", "onehot", False),
    ("cylinder", "auto", False),
])
def test_f32_matches_pallas_forms(mesh_name, form, packed):
    """The port in float32 against both Pallas forms (interpret mode): the
    packed home-slot form and the one-hot form on the planar mesh, and
    the auto choice on the RCM cylinder, which is the one-hot fallback."""
    ours, ref = MESHES[mesh_name]
    mesh, jmesh = ours(), ref()
    host = inputs(mesh, seed=3)
    U, V = Stress2RhsSolver(mesh, torch.float32, device="cpu")(*host)
    with pltpu.force_tpu_interpret_mode():
        s = JaxStress2RhsSolver(jmesh, dtype=jnp.float32, backend="pallas",
                                form=form)
        assert s._packed == packed
        jU, jV = s(*host)
    assert U.dtype == torch.float32
    for got, want, comp in ((U, jU, "U"), (V, jV, "V")):
        err = _relerr(got.numpy(), want)
        assert err <= F32_RELERR, f"{mesh_name} {form} {comp}: {err:.2e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pack_then_call_packed_equals_call(dtype):
    mesh = generate_cylinder_mesh(48, 16, 8)[0]
    host = inputs(mesh, seed=5)
    solver = Stress2RhsSolver(mesh, dtype, device="cpu")
    U, V = solver(*host)
    packed = solver.pack_elem_inputs(*host[:7])
    assert packed.dtype == dtype and packed.is_contiguous()
    pU, pV = solver.call_packed(packed, *host[7:])
    assert torch.equal(U, pU) and torch.equal(V, pV)
    # tensors already on the device pass through as they are
    tU, _ = solver.call_packed(packed, *(torch.tensor(a, dtype=dtype)
                                         for a in host[7:]))
    assert torch.equal(U, tU)


def test_ten_substep_evp_loop_matches_jax(case):
    """A 10-substep EVP loop (each U feeds the next rhs_a) against the JAX
    xla solver's loop, f64."""
    name, mesh, jmesh, host = case
    coupling = 1e-3
    solver = Stress2RhsSolver(mesh, torch.float64, device="cpu")
    packed = solver.pack_elem_inputs(*host[:7])
    iam, ra, rm = (torch.from_numpy(a) for a in host[7:])
    jsolver = JaxStress2RhsSolver(jmesh, dtype=jnp.float64, backend="xla")
    jra = jnp.asarray(host[8])
    for _ in range(10):
        U, V = solver.call_packed(packed, iam, ra, rm)
        ra = ra + coupling * U
        jU, jV = jsolver(*host[:8], jra, host[9])
        jra = jra + coupling * jU
    masked_allclose(U.numpy(), np.asarray(jU), msg=f"{name} U")
    masked_allclose(V.numpy(), np.asarray(jV), msg=f"{name} V")
    masked_allclose(ra.numpy(), np.asarray(jra), msg=f"{name} rhs_a")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ice_free_and_massless_are_exact(dtype):
    """Every element ice-free: U, V are exactly rhs where inv_areamass > 0
    (and 0 elsewhere).  Every node massless: exact zeros."""
    mesh = read_fesom_mesh(POLAR_CAP, reorder=False)[0]
    host = inputs(mesh, seed=11)
    solver = Stress2RhsSolver(mesh, dtype, device="cpu")
    iam, ra, rm = (torch.tensor(a, dtype=dtype) for a in host[7:])
    U, V = solver(host[0], -np.abs(host[1]), *host[2:7], iam, ra, rm)
    assert torch.equal(U, torch.where(iam > 0, ra, 0.0))
    assert torch.equal(V, torch.where(iam > 0, rm, 0.0))
    U, V = solver(*host[:7], -iam.abs(), ra, rm)
    assert not U.any() and not V.any()


def test_cuda_backend_needs_cuda_device():
    mesh = generate_planar_mesh(preset="toy")
    with pytest.raises(ValueError, match="CUDA device"):
        Stress2RhsSolver(mesh, torch.float32, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        Stress2RhsSolver(mesh, torch.float32, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        Stress2RhsSolver(mesh, torch.float16, device="cpu")


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    """On CPU tensors the wrapper returns its plain version and launches
    nothing; mesh data off the CPU and off CUDA is refused, and so is an
    incidence row wider than the kernel's slots."""
    mesh = generate_planar_mesh(preset="tiny")
    host = inputs(mesh)
    solver = Stress2RhsSolver(mesh, torch.float64, device="cpu")
    slab = solver.pack_elem_inputs(*host[:7])
    node = [torch.from_numpy(a) for a in host[7:]]
    kernels.reset_launch_counts()
    got = kernels.stress2rhs(solver.md, slab, *node)
    ref = kernels.stress2rhs_ref(solver.md, slab, *node)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert kernels.launch_counts()["stress2rhs"] == 0
    assert build.library.cache_info().currsize == 0

    md = build_mesh_data(mesh, torch.float32, "meta")
    N, E = md.n_nodes, md.n_elems
    mslab = torch.empty((kernels.SLAB_ROWS, E), device="meta")
    row = torch.empty((N,), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.stress2rhs(md, mslab, row, row, row)
    wide = dataclasses.replace(md, ne_slot=torch.empty(
        (kernels.MAX_DEGREE + 1, N), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="incidence slots"):
        kernels.stress2rhs(wide, mslab, row, row, row)


def test_mesh_data_slot_codes_follow_incidence():
    """ne_slot[k, n] = 3 * element + corner for each valid slot, -1 in
    padding, valid slots first: the incidence H-S2R reads."""
    mesh = read_fesom_mesh(POLAR_CAP)[0]
    md = build_mesh_data(mesh, torch.float64, "cpu")
    codes = md.ne_slot.numpy()
    assert codes.shape == (mesh.node_elems.shape[1], mesh.n_nodes)
    valid = codes >= 0
    np.testing.assert_array_equal(valid.sum(axis=0), mesh.node_elems_num)
    np.testing.assert_array_equal(valid, md.ne_k.numpy().T)
    e, corner = codes // 3, codes % 3
    np.testing.assert_array_equal(e[valid], mesh.node_elems.T[valid])
    n = np.broadcast_to(np.arange(mesh.n_nodes), codes.shape)[valid]
    np.testing.assert_array_equal(mesh.elem_nodes[e[valid], corner[valid]], n)
