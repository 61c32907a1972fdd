"""PyTorch port: the native mesh core and CPU golden reference
(``native/fesom2_torch_core.cpp`` built by ``native/build.py``, bound by
``mesh/native.py``), the counterpart of tests/test_native.py.

* ``build_edges`` and ``ragged_to_padded`` equal, array for array, to the
  port's numpy topology and to the JAX package's native core, on ``toy``,
  ``small``, the RCM cylinder and ``tests/data/polar_cap``;
* ``NativeReference.step`` bit for bit against the JAX
  ``NativeReference.step`` (the same source, built with the same flags),
  and within 1e-12 of the port's numpy oracle, iter_yn both ways;
* ``stress2rhs`` (``f2t_stress2rhs``) within 1e-12 of the port's oracle;
* the two ``extern "C"`` blocks declare the same names and parameter
  lists, and ``mesh/native.py`` declares a signature for each;
* a build that cannot run (no such compiler) or fails raises, and
  ``load`` never returns None;
* the core and the host-embedding shim load in one process (ctypes'
  ``RTLD_LOCAL``), and each call reaches its own library;
* the built shim's ``f2t_setup_part_`` -> ``f2t_fct_ale_pre_comm_`` ->
  ``f2t_fct_ale_post_comm_`` on one rank (no halo), backend 0 on the
  CPU, give ``f2t_fct_ale_step_``'s buffers bit for bit.

Each test skips where there is no C++ compiler (``native.available``),
as tests/test_native.py does."""

import ctypes
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from fesom2_accelerate_tpu.mesh import fesom_io as jax_fesom_io
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.mesh import native as jax_native
from fesom2_accelerate_tpu.mesh.generate import (
    generate_cylinder_mesh as jax_cylinder_mesh,
)
from fesom2_accelerate_tpu_torch.mesh import (
    generate_cylinder_mesh,
    generate_planar_mesh,
    random_fields,
    read_fesom_mesh,
)
from fesom2_accelerate_tpu_torch.mesh import native, topology
from fesom2_accelerate_tpu_torch.native import build
from fesom2_accelerate_tpu_torch.ops import oracle

from conftest import masked_allclose

REPO = pathlib.Path(__file__).resolve().parents[1]
POLAR_CAP = os.path.join(os.path.dirname(__file__), "data", "polar_cap")
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


@pytest.fixture(autouse=True)
def _compiler():
    if not native.available():
        pytest.skip("no C++ compiler to build the native core")


@pytest.fixture(scope="module")
def meshes():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = tuple(f() for f in MESHES[name])
        return cache[name]

    return get


def _incidences(mesh):
    """(rows, cols, extra, n_rows) of the node -> element and node -> edge
    incidences, as ``topology.build_mesh_from_elements`` builds them."""
    E, Ed = mesh.n_elems, mesh.n_edges
    return (
        (mesh.elem_nodes.ravel(), np.repeat(np.arange(E, dtype=np.int32), 3),
         np.tile(np.arange(3, dtype=np.int32), E), mesh.n_nodes),
        (mesh.edges.ravel(), np.repeat(np.arange(Ed, dtype=np.int32), 2),
         np.tile(np.array([1, -1], dtype=np.int8), Ed), mesh.n_nodes),
    )


@pytest.mark.parametrize("name", list(MESHES))
def test_build_edges_matches_topology_and_jax(meshes, name):
    mesh, jmesh = meshes(name)
    edges, edge_tri = native.build_edges(mesh.elem_nodes)
    np.testing.assert_array_equal(edges, mesh.edges)
    np.testing.assert_array_equal(edge_tri, mesh.edge_tri)
    ref = topology._build_edges(mesh.elem_nodes)
    jref = jax_native.build_edges(jmesh.elem_nodes)
    for ours, r, jr in zip((edges, edge_tri), ref, jref):
        assert ours.dtype == r.dtype == jr.dtype
        np.testing.assert_array_equal(ours, r)
        np.testing.assert_array_equal(ours, jr)


@pytest.mark.parametrize("name", list(MESHES))
def test_ragged_to_padded_matches_topology_and_jax(meshes, name):
    mesh, _ = meshes(name)
    elems, edges = _incidences(mesh)
    got = native.ragged_to_padded(*elems[:2], elems[3], extra=elems[2])
    for ours, want in zip(got, (mesh.node_elems, mesh.node_elems_num,
                                mesh.node_elems_pos)):
        np.testing.assert_array_equal(ours, want)
    got = native.ragged_to_padded(*edges[:2], edges[3], extra=edges[2])
    for ours, want in zip(got, (mesh.node_edges, mesh.node_edges_num,
                                mesh.node_edges_sign)):
        assert ours.dtype == want.dtype
        np.testing.assert_array_equal(ours, want)
    for rows, cols, extra, n_rows in (elems, edges):
        for kw in ({}, {"extra": extra}):
            ours = native.ragged_to_padded(rows, cols, n_rows, **kw)
            np.testing.assert_equal(
                ours, topology._ragged_to_padded(rows, cols, n_rows, **kw))
            np.testing.assert_equal(
                ours, jax_native.ragged_to_padded(rows, cols, n_rows, **kw))


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("name", list(MESHES))
def test_reference_step_matches_jax_and_oracle(meshes, name, iter_yn):
    mesh, jmesh = meshes(name)
    fields = random_fields(mesh, seed=5)
    out = native.NativeReference(mesh).step(fields, dt=0.7, iter_yn=iter_yn)
    jout = jax_native.NativeReference(jmesh).step(fields, dt=0.7,
                                                  iter_yn=iter_yn)
    assert out.keys() == jout.keys()
    for k in jout:
        assert np.array_equal(out[k], jout[k]), f"{k}: not bit-exact"
    ref = oracle.fct_ale_step(mesh, fields, vlimit=1, iter_yn=iter_yn,
                              dt=0.7)
    assert out.keys() == ref.keys()
    for k in ref:
        masked_allclose(out[k], ref[k], msg=f"native[{k}] iter={iter_yn}")


@pytest.mark.parametrize("name", list(MESHES))
def test_stress2rhs_matches_oracle(meshes, name):
    mesh, _ = meshes(name)
    rng = np.random.default_rng(9)
    E, N = mesh.n_elems, mesh.n_nodes
    elem_area = np.abs(rng.standard_normal(E)) + 0.1
    ice_strength = rng.standard_normal(E)
    s11, s12, s22 = rng.standard_normal((3, E))
    grad = rng.standard_normal((6, E))
    mf = rng.standard_normal(E)
    iam = rng.standard_normal(N)
    rhs_a, rhs_m = rng.standard_normal((2, N))
    U, V = native.stress2rhs(mesh.elem_nodes, elem_area, ice_strength, s11,
                             s12, s22, grad, mf, iam, rhs_a, rhs_m)
    rU, rV = oracle.stress2rhs(
        mesh.elem_nodes, mesh.node_elems, mesh.node_elems_pos,
        mesh.node_elems_num, elem_area, ice_strength, s11, s12, s22, grad,
        mf, iam, rhs_a, rhs_m)
    masked_allclose(U, rU, msg="native stress2rhs U")
    masked_allclose(V, rV, msg="native stress2rhs V")
    with pytest.raises(ValueError, match="shape"):
        native.stress2rhs(mesh.elem_nodes, elem_area[:-1], ice_strength, s11,
                          s12, s22, grad, mf, iam, rhs_a, rhs_m)


def test_reference_step_checks_shapes(meshes):
    mesh, _ = meshes("toy")
    fields = random_fields(mesh, seed=5)
    fields["fct_adf_h"] = fields["fct_adf_h"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        native.NativeReference(mesh).step(fields)


def _extern_c(path: pathlib.Path) -> dict:
    """name -> (return type, parameter list with whitespace collapsed) of
    each function defined in the file's ``extern "C"`` block."""
    text = path.read_text()
    block = text[text.index('extern "C" {'):]
    sigs = re.findall(r"(\w+)\s+(f2t_\w+)\s*\(([^)]*)\)\s*\{", block)
    return {name: (ret, " ".join(params.split()))
            for ret, name, params in sigs}


def test_c_surface_matches_jax_core():
    ours = _extern_c(build.CORE)
    assert ours == _extern_c(REPO / "native" / "fesom2_tpu_core.cpp")
    assert set(ours) == set(native._SIGNATURES)
    ctype = {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32,
             "double": ctypes.c_double, "void": None}
    for name, (ret, params) in ours.items():
        want = tuple(ctypes.c_void_p if "*" in p else ctype[p.split()[0]]
                     for p in re.sub(r"/\*.*?\*/", "", params).split(","))
        assert native._SIGNATURES[name] == (ctype[ret], want), name
    # the port's build never reaches into native/
    assert build.CORE.parent == REPO / "fesom2_accelerate_tpu_torch" / \
        "native"


@pytest.mark.parametrize("cxx", ["no-such-compiler-f2t", "false"])
def test_failed_build_raises(monkeypatch, cxx):
    """A compiler that does not exist, and one that fails (``false``):
    the build raises, and so does ``load``, which never returns None."""
    monkeypatch.setenv("CXX", cxx)
    assert native.available() == (cxx == "false")
    match = "not found" if cxx != "false" else "failed"
    with pytest.raises(RuntimeError, match=match):
        build.build_core()
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=match):
            native.load()
    finally:
        native.load.cache_clear()
    assert not list(build.BUILD_DIR.glob("*.tmp"))


def test_core_and_host_shim_in_one_process():
    """Both libraries load with ctypes' default RTLD_LOCAL; neither
    resolves the other's names, each function lies in its own library's
    mapping, and each call reaches its own library: the core derives the
    toy mesh's edges, the shim sets up the toy mesh (backend 0, asked for
    on the CPU with ``FESOM2_TORCH_DEVICE=cpu``) and reports its sizes
    through the embedded interpreter (this process's)."""
    if not build.available():
        pytest.skip("host embedding shim unavailable (no g++ or libpython)")
    code = r"""
import ctypes
import numpy as np
from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh, native
from fesom2_accelerate_tpu_torch.native import build

core = native.load()
shim = ctypes.CDLL(str(build.build()[0]))
assert not hasattr(core, "f2t_init_") and not hasattr(shim, "f2t_a1")


def mapping(path):
    spans = []
    for line in open("/proc/self/maps"):
        if line.rstrip().endswith(path):
            lo, hi = line.split()[0].split("-")
            spans.append((int(lo, 16), int(hi, 16)))
    return spans


for lib, names in ((core, ("f2t_a1", "f2t_build_edges")),
                   (shim, ("f2t_init_", "f2t_dims_"))):
    for n in names:
        addr = ctypes.cast(getattr(lib, n), ctypes.c_void_p).value
        assert any(lo <= addr < hi for lo, hi in mapping(lib._name)), n
mesh = generate_planar_mesh(preset="toy")
edges, _ = native.build_edges(mesh.elem_nodes)
assert np.array_equal(edges, mesh.edges)
i = ctypes.c_int
st = i(1)
en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
nl_e = np.ascontiguousarray(mesh.nlev_elem, np.int32)
xy = np.ascontiguousarray(mesh.node_xy, np.float64)
p = ctypes.c_void_p
shim.f2t_setup_(ctypes.byref(i(mesh.n_elems)), ctypes.byref(i(mesh.nl)),
                en.ctypes.data_as(p), nl_e.ctypes.data_as(p),
                ctypes.byref(i(mesh.n_nodes)), xy.ctypes.data_as(p),
                ctypes.byref(i(500)), ctypes.byref(i(1)),
                ctypes.byref(i(0)), ctypes.byref(i(0)), ctypes.byref(st))
assert st.value == 0
dims = [i(0), i(0), i(0)]
shim.f2t_dims_(*(ctypes.byref(d) for d in dims), ctypes.byref(st))
assert st.value == 0
assert [d.value for d in dims] == [mesh.n_nodes, mesh.n_edges,
                                   mesh.n_layers]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO),
                                   FESOM2_TORCH_DEVICE="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_shim_phases_on_one_rank_are_the_step():
    """Through the built library only (ctypes, this process's
    interpreter): ``f2t_setup_`` and two ``f2t_fct_ale_step_`` calls, then
    ``f2t_setup_part_`` with every node owned and two rounds of
    ``f2t_fct_ale_pre_comm_`` / ``f2t_fct_ale_post_comm_`` on fresh copies
    of the same fields: the eight buffers bit for bit alike, and the
    factors of every column written."""
    if not build.available():
        pytest.skip("host embedding shim unavailable (no g++ or libpython)")
    code = r"""
import ctypes
import numpy as np
from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh
from fesom2_accelerate_tpu_torch.mesh import random_fields
from fesom2_accelerate_tpu_torch.native import build, demo

shim = ctypes.CDLL(str(build.build()[0]))
mesh = generate_planar_mesh(preset="toy")
fields = random_fields(mesh, seed=3)
i, p = ctypes.c_int, ctypes.c_void_p
en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
nl_e = np.ascontiguousarray(mesh.nlev_elem, np.int32)
xy = np.ascontiguousarray(mesh.node_xy, np.float64)
st = i(1)


def ref(*ints):
    return [ctypes.byref(i(v)) for v in ints]


def bufs():
    return {k: np.array(fields[k], np.float64) for k, _ in demo.FIELD_FILES}


by_step, by_phases = bufs(), bufs()
factors = [np.zeros(by_step["ttf"].shape) for _ in range(2)]
shim.f2t_init_(ctypes.byref(st))
assert st.value == 0
shim.f2t_setup_(*ref(mesh.n_elems, mesh.nl), en.ctypes.data_as(p),
                nl_e.ctypes.data_as(p), *ref(mesh.n_nodes),
                xy.ctypes.data_as(p), *ref(500, 1, 0, 0), ctypes.byref(st))
assert st.value == 0
step = [by_step[k].ctypes.data_as(p) for k, _ in demo.FIELD_FILES]
for _ in range(2):
    shim.f2t_fct_ale_step_(*step, ctypes.byref(st))
    assert st.value == 0
shim.f2t_setup_part_(*ref(mesh.n_elems, mesh.nl), en.ctypes.data_as(p),
                     nl_e.ctypes.data_as(p), *ref(mesh.n_nodes, mesh.n_nodes),
                     xy.ctypes.data_as(p), *ref(500, 1, 0, 0),
                     ctypes.byref(st))
assert st.value == 0
ten = [by_phases[k].ctypes.data_as(p) for k, _ in demo.FIELD_FILES] + [
    a.ctypes.data_as(p) for a in factors]
for _ in range(2):
    shim.f2t_fct_ale_pre_comm_(*ten, ctypes.byref(st))
    assert st.value == 0
    shim.f2t_fct_ale_post_comm_(*ten, ctypes.byref(st))
    assert st.value == 0
shim.f2t_fct_ale_post_comm_(*ten, ctypes.byref(st))
assert st.value == 1  # no pre_comm before it
shim.f2t_finalize_(ctypes.byref(st))
assert st.value == 0
for k, v in by_step.items():
    assert np.array_equal(by_phases[k].view(np.uint64), v.view(np.uint64)), k
assert all(np.abs(a).max() > 0 for a in factors)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO),
                                   FESOM2_TORCH_DEVICE="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"
