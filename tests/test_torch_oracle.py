"""PyTorch port: the numpy oracles (``ops/oracle.py``, ``ops/oracle_loops.py``)
against the JAX package's, the port's loops against the port's oracle, and
the port's plain torch step against the port's oracle.

* every function of the port's ``oracle`` against the JAX module's, bit for
  bit (``np.array_equal``), on ``toy``, ``small``, the RCM cylinder and
  ``tests/data/polar_cap``: each stage in the chain ``fct_ale_step`` runs,
  fed the same inputs, then ``fct_ale_step`` for vlimit 1/2/3 x iter_yn
  and ``stress2rhs``;
* every function of the port's ``oracle_loops`` against the JAX module's,
  bit for bit, on ``toy`` only (O(N L) Python loops);
* the port's loops against the port's oracle stage by stage, as
  tests/test_oracle.py holds the JAX pair (1e-12; the whole chain at rtol
  1e-10, as there);
* the port's ``fct_ale_step`` (plain torch, f64, CPU) against the port's
  oracle, vlimit 1/2/3 x iter_yn, 1e-12.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.mesh import fesom_io as jax_fesom_io
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.mesh.generate import (
    generate_cylinder_mesh as jax_cylinder_mesh,
)
from fesom2_accelerate_tpu.ops import oracle as jax_oracle
from fesom2_accelerate_tpu.ops import oracle_loops as jax_loops
from fesom2_accelerate_tpu_torch import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import (
    generate_cylinder_mesh,
    generate_planar_mesh,
    random_fields,
    read_fesom_mesh,
)
from fesom2_accelerate_tpu_torch.model.fct_ale import fct_ale_step
from fesom2_accelerate_tpu_torch.ops import oracle, oracle_loops
from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data

from conftest import masked_allclose

POLAR_CAP = os.path.join(os.path.dirname(__file__), "data", "polar_cap")
DT = 0.7
MESHES = {
    "toy": (lambda: generate_planar_mesh(preset="toy"),
            lambda: jax_planar_mesh(preset="toy")),
    "small": (lambda: generate_planar_mesh(preset="small"),
              lambda: jax_planar_mesh(preset="small")),
    "cylinder": (lambda: generate_cylinder_mesh(48, 16, 8)[0],
                 lambda: jax_cylinder_mesh(48, 16, 8)[0]),
    "polar_cap": (lambda: read_fesom_mesh(POLAR_CAP)[0],
                  lambda: jax_fesom_io.read_fesom_mesh(POLAR_CAP)[0]),
}
STEP_CASES = [(v, it) for v in (1, 2, 3) for it in (False, True)]


@pytest.fixture(scope="module")
def meshes():
    """name -> (port mesh, JAX mesh, fields), built once."""
    cache = {}

    def get(name):
        if name not in cache:
            ours, ref = MESHES[name]
            mesh = ours()
            cache[name] = (mesh, ref(), random_fields(mesh, seed=4))
        return cache[name]

    return get


def _functions(module) -> set:
    return {n for n, f in inspect.getmembers(module, inspect.isfunction)
            if f.__module__ == module.__name__}


def _equal(ours, ref, what):
    if isinstance(ref, dict):
        assert ours.keys() == ref.keys(), what
        for k in ref:
            _equal(ours[k], ref[k], f"{what}[{k}]")
    elif isinstance(ref, tuple):
        assert isinstance(ours, tuple) and len(ours) == len(ref), what
        for i, (a, b) in enumerate(zip(ours, ref)):
            _equal(a, b, f"{what}[{i}]")
    else:
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, what
        assert np.array_equal(ours, ref), f"{what}: not bit-exact"


def _stage_calls(mod, mesh, f):
    """Every function of the vectorized oracle, in the order of its chain
    (vlimit 1 feeding b), each on the outputs of the one before ->
    {name: output}."""
    out = {}
    mk = out["masks"] = mod.masks(mesh)
    tmax, tmin = out["a1"] = mod.a1(mesh, mk, f["fct_LO"], f["ttf"])
    UV_max, UV_min = out["a2"] = mod.a2(mesh, mk, tmax, tmin)
    out["_cluster_reduce"] = mod._cluster_reduce(mesh, mk, UV_max, UV_min)
    out["_vertical_window"] = (mod._vertical_window(tmax, True),
                               mod._vertical_window(tmin, False))
    out["a3_vlimit2"] = mod.a3_vlimit2(mesh, mk, UV_max, UV_min, tmax,
                                       f["fct_LO"])
    out["a3_vlimit3"] = mod.a3_vlimit3(mesh, mk, UV_max, UV_min, tmax,
                                       f["fct_LO"])
    out["_a3_vlimit23"] = mod._a3_vlimit23(mesh, mk, UV_max, UV_min, tmax,
                                           f["fct_LO"], widen=True)
    tmax2, tmin2 = out["a3_vlimit1"] = mod.a3_vlimit1(mesh, mk, UV_max,
                                                      UV_min, f["fct_LO"])
    p, m = out["b1_vertical"] = mod.b1_vertical(mesh, mk, f["fct_adf_v"])
    p, m = out["b1_horizontal"] = mod.b1_horizontal(mesh, mk, p, m,
                                                    f["fct_adf_h"])
    p, m = out["b2"] = mod.b2(mesh, mk, p, m, tmax2, tmin2, DT)
    for it in (False, True):
        out[f"b3_vertical_{it}"] = mod.b3_vertical(mesh, mk, p, m,
                                                   f["fct_adf_v"], it)
        out[f"b3_horizontal_{it}"] = mod.b3_horizontal(mesh, mk, p, m,
                                                       f["fct_adf_h"], it)
    adf_v = out["b3_vertical_False"]
    adf_h = out["b3_horizontal_False"]
    out["_edge_flux_to_nodes"] = mod._edge_flux_to_nodes(mesh, mk, adf_h)
    out["c_update_solution"] = mod.c_update_solution(
        mesh, mk, f["ttf"], f["hnode"], f["hnode_new"], f["fct_LO"], adf_v,
        adf_h, f["del_ttf_advvert"], f["del_ttf_advhoriz"], DT)
    out["c_update_LO"] = mod.c_update_LO(mesh, mk, f["fct_LO"], adf_v, adf_h,
                                         f["hnode_new"], DT)
    return out


def _s2r_inputs(mesh, seed=3):
    """tests/test_oracle.py's stress2rhs inputs: about half the elements
    ice-free, some nodes massless."""
    rng = np.random.default_rng(seed)
    E, N = mesh.n_elems, mesh.n_nodes
    elem_area = np.abs(rng.standard_normal(E)) + 0.1
    ice_strength = rng.standard_normal(E)
    sigma11, sigma12, sigma22 = rng.standard_normal((3, E))
    gradient_sca = rng.standard_normal((6, E))
    metric_factor = rng.standard_normal(E)
    inv_areamass = rng.standard_normal(N)
    rhs_a, rhs_m = rng.standard_normal((2, N))
    return (elem_area, ice_strength, sigma11, sigma12, sigma22,
            gradient_sca, metric_factor, inv_areamass, rhs_a, rhs_m)


def _s2r(mod, mesh, inputs):
    return mod.stress2rhs(mesh.elem_nodes, mesh.node_elems,
                          mesh.node_elems_pos, mesh.node_elems_num, *inputs)


@pytest.mark.parametrize("module,ref", [(oracle, jax_oracle),
                                        (oracle_loops, jax_loops)])
def test_same_functions_as_jax(module, ref):
    assert _functions(module) == _functions(ref)
    assert "import jax" not in inspect.getsource(module)


@pytest.mark.parametrize("name", list(MESHES))
def test_oracle_stages_bit_exact_vs_jax(meshes, name):
    mesh, jmesh, f = meshes(name)
    ours = _stage_calls(oracle, mesh, f)
    ref = _stage_calls(jax_oracle, jmesh, f)
    assert ours.keys() == ref.keys()
    called = {k.rsplit("_", 1)[0] if k.endswith(("_True", "_False")) else k
              for k in ours}
    # every function but the chain and stress2rhs, which have their tests
    assert called == _functions(oracle) - {"fct_ale_step", "stress2rhs"}
    _equal(ours, ref, name)


@pytest.mark.parametrize("vlimit,iter_yn", STEP_CASES)
@pytest.mark.parametrize("name", list(MESHES))
def test_oracle_step_bit_exact_vs_jax(meshes, name, vlimit, iter_yn):
    mesh, jmesh, f = meshes(name)
    kw = dict(vlimit=vlimit, iter_yn=iter_yn, dt=DT)
    _equal(oracle.fct_ale_step(mesh, f, **kw),
           jax_oracle.fct_ale_step(jmesh, f, **kw), name)


@pytest.mark.parametrize("name", list(MESHES))
def test_oracle_stress2rhs_bit_exact_vs_jax(meshes, name):
    mesh, jmesh, _ = meshes(name)
    inputs = _s2r_inputs(mesh)
    _equal(_s2r(oracle, mesh, inputs), _s2r(jax_oracle, jmesh, inputs),
           name)


def _loop_calls(mod, mesh, f, vlimit, iter_yn):
    """Every function of the loop oracle on ``mesh`` -> {name: output}."""
    out = {}
    tmax, tmin = out["a1"] = mod.a1(mesh, f["fct_LO"], f["ttf"])
    UV_max, UV_min = out["a2"] = mod.a2(mesh, tmax, tmin)
    out["a3_vlimit1"] = mod.a3_vlimit1(mesh, UV_max, UV_min, f["fct_LO"])
    out["a3_vlimit2"] = mod.a3_vlimit2(mesh, UV_max, UV_min, tmax,
                                       f["fct_LO"])
    out["a3_vlimit3"] = mod.a3_vlimit3(mesh, UV_max, UV_min, tmax,
                                       f["fct_LO"])
    # _tvert leaves the rows below a node's active levels unset
    out["_tvert"] = tuple(
        tuple(a[: mesh.nlev_nod[n] - 1]
              for a in mod._tvert(mesh, UV_max, UV_min, n))
        for n in range(mesh.n_nodes))
    tmax2, tmin2 = out["a3_vlimit1"]
    p, m = out["b1_vertical"] = mod.b1_vertical(mesh, f["fct_adf_v"])
    p, m = out["b1_horizontal"] = mod.b1_horizontal(mesh, p, m,
                                                    f["fct_adf_h"])
    p, m = out["b2"] = mod.b2(mesh, p, m, tmax2, tmin2, dt=DT)
    adf_v = out["b3_vertical"] = mod.b3_vertical(mesh, p, m, f["fct_adf_v"],
                                                 iter_yn)
    adf_h = out["b3_horizontal"] = mod.b3_horizontal(mesh, p, m,
                                                     f["fct_adf_h"], iter_yn)
    if iter_yn:
        adf_v, adf_h = adf_v[0], adf_h[0]
    out["c_update_solution"] = mod.c_update_solution(
        mesh, f["ttf"], f["hnode"], f["hnode_new"], f["fct_LO"], adf_v,
        adf_h, f["del_ttf_advvert"], f["del_ttf_advhoriz"], DT)
    out["c_update_LO"] = mod.c_update_LO(mesh, f["fct_LO"], adf_v, adf_h,
                                         f["hnode_new"], DT)
    out["fct_ale_step"] = mod.fct_ale_step(mesh, f, vlimit=vlimit,
                                           iter_yn=iter_yn, dt=DT)
    out["stress2rhs"] = mod.stress2rhs(mesh.elem_nodes,
                                       *_s2r_inputs(mesh), mesh.n_nodes)
    return out


@pytest.mark.parametrize("vlimit,iter_yn", [(1, False), (3, True)])
def test_loops_bit_exact_vs_jax(meshes, vlimit, iter_yn):
    mesh, jmesh, f = meshes("toy")
    ours = _loop_calls(oracle_loops, mesh, f, vlimit, iter_yn)
    assert set(ours) == _functions(oracle_loops)
    _equal(ours, _loop_calls(jax_loops, jmesh, f, vlimit, iter_yn), "toy")


@pytest.fixture(scope="module", params=[0, 1])
def tiny(request):
    """tests/test_oracle.py's randomized tiny meshes."""
    mesh = generate_planar_mesh(nx=6, ny=5, nl=7, seed=request.param)
    mesh.validate()
    return mesh, random_fields(mesh, seed=request.param), oracle.masks(mesh)


@pytest.mark.parametrize("stage", ["a1", "a2", "a3_vlimit1", "a3_vlimit2",
                                   "a3_vlimit3", "b1_vertical",
                                   "b1_horizontal", "b2", "b3_vertical",
                                   "b3_horizontal", "c_update_solution",
                                   "c_update_LO", "stress2rhs"])
def test_loops_match_oracle(tiny, stage):
    """Each loop stage against the vectorized stage on the vectorized
    stages' inputs (tests/test_oracle.py), iter_yn both ways for b3."""
    mesh, f, mk = tiny
    v = _stage_calls(oracle, mesh, f)
    tmax, tmin = v["a1"]
    UV_max, UV_min = v["a2"]
    tmax2, tmin2 = v["a3_vlimit1"]
    b1p, b1m = v["b1_vertical"]
    p, m = v["b1_horizontal"]
    fp, fm = v["b2"]
    adf_v, adf_h = v["b3_vertical_False"], v["b3_horizontal_False"]
    lo = f["fct_LO"]
    if stage == "stress2rhs":
        inputs = _s2r_inputs(mesh)
        pairs = [(oracle_loops.stress2rhs(mesh.elem_nodes, *inputs,
                                          mesh.n_nodes),
                  _s2r(oracle, mesh, inputs))]
    elif stage in ("b3_vertical", "b3_horizontal"):
        field = f["fct_adf_v" if stage == "b3_vertical" else "fct_adf_h"]
        pairs = [(getattr(oracle_loops, stage)(mesh, fp, fm, field, it),
                  v[f"{stage}_{it}"]) for it in (False, True)]
    else:
        loop_args = {
            "a1": (lo, f["ttf"]),
            "a2": (tmax, tmin),
            "a3_vlimit1": (UV_max, UV_min, lo),
            "a3_vlimit2": (UV_max, UV_min, tmax, lo),
            "a3_vlimit3": (UV_max, UV_min, tmax, lo),
            "b1_vertical": (f["fct_adf_v"],),
            "b1_horizontal": (b1p, b1m, f["fct_adf_h"]),
            "b2": (p, m, tmax2, tmin2, DT),
            "c_update_solution": (f["ttf"], f["hnode"], f["hnode_new"], lo,
                                  adf_v, adf_h, f["del_ttf_advvert"],
                                  f["del_ttf_advhoriz"], DT),
            "c_update_LO": (lo, adf_v, adf_h, f["hnode_new"], DT),
        }[stage]
        pairs = [(getattr(oracle_loops, stage)(mesh, *loop_args), v[stage])]
    for loop_out, vec_out in pairs:
        loop_out = loop_out if isinstance(loop_out, tuple) else (loop_out,)
        vec_out = vec_out if isinstance(vec_out, tuple) else (vec_out,)
        assert len(loop_out) == len(vec_out)
        for i, (a, b) in enumerate(zip(loop_out, vec_out)):
            masked_allclose(a, b, msg=f"{stage}[{i}]")


@pytest.mark.parametrize("vlimit,iter_yn", STEP_CASES)
def test_loop_chain_matches_oracle(tiny, vlimit, iter_yn):
    mesh, f, mk = tiny
    out_l = oracle_loops.fct_ale_step(mesh, f, vlimit=vlimit,
                                      iter_yn=iter_yn, dt=DT)
    out_v = oracle.fct_ale_step(mesh, f, vlimit=vlimit, iter_yn=iter_yn,
                                dt=DT, mk=mk)
    assert set(out_l) == set(out_v)
    for key in out_l:
        masked_allclose(out_l[key], out_v[key], rtol=1e-10, atol=1e-12,
                        msg=f"chain[{key}] vlimit={vlimit} iter={iter_yn}")


@pytest.mark.parametrize("vlimit,iter_yn", STEP_CASES)
def test_torch_step_matches_port_oracle(meshes, vlimit, iter_yn):
    mesh, _, f = meshes("small")
    cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=DT,
                       dtype=torch.float64)
    out = fct_ale_step(build_mesh_data(mesh, torch.float64, "cpu"), cfg,
                       {k: torch.from_numpy(v) for k, v in f.items()})
    ref = oracle.fct_ale_step(mesh, f, vlimit=vlimit, iter_yn=iter_yn,
                              dt=DT)
    for key, val in ref.items():
        masked_allclose(out[key].numpy(), val, msg=f"oracle[{key}]")
