"""PyTorch port: the plain versions of the three FCT CUDA kernels against
the JAX package's Pallas step, the wrappers' device rules, and the build
command of every kernel source.

The CUDA kernels themselves run only on a GPU (``python3 chip_smoke.py``
holds each against its plain version there).  Here each plain version
(``bounds_ref``, ``limit_ref``, ``update_fused_ref``) is fed the JAX Pallas
step's own inputs and intermediates, with the Pallas kernels run in TPU
interpret mode as tests/test_pallas.py runs them, and compared in float32:
fct_ttf_max/min bit-exact (max/min and one subtraction), every other
output within relerr 1e-6 (another summation order, f32 rounding)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fesom2_accelerate_tpu.config import FctAleConfig as JaxFctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.ops import stages as jax_stages
from fesom2_accelerate_tpu.ops.meshdata import build_mesh_data as jax_mesh_data
from fesom2_accelerate_tpu.ops.pallas.step import (
    build_pallas_data,
    fct_ale_step_pallas,
)
from fesom2_accelerate_tpu_torch import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu_torch.model.fct_ale import fct_ale_step
from fesom2_accelerate_tpu_torch.ops.cuda import build, kernels
from fesom2_accelerate_tpu_torch.ops.cuda.step import fct_ale_step_cuda
from fesom2_accelerate_tpu_torch.ops.meshdata import (
    LIMIT_FUSED_LEVELS,
    LIMIT_LEVELS,
    TILE_NODES,
    UPDATE_SPLIT_LEVELS,
    build_mesh_data,
)

from conftest import masked_allclose

DT, EPS = 0.7, 1e-7
F32_RELERR = 1e-6


def _relerr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


@pytest.fixture(scope="module")
def tiny():
    mesh = generate_planar_mesh(preset="tiny")
    pd, ps = build_pallas_data(jax_planar_mesh(preset="tiny"))
    assert ps.a3f_dia_D and ps.pack_K and ps.fuse_k34, \
        "tiny must take the main path's DIA K1 / packed K2 / fused K34"
    fields = random_fields(mesh, seed=11, dtype=np.float32)
    md = build_mesh_data(mesh, torch.float32, "cpu")
    return mesh, pd, ps, fields, md


@pytest.mark.parametrize("vlimit", [1, 2, 3])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_plain_kernels_match_pallas_intermediates(tiny, vlimit, iter_yn):
    mesh, pd, ps, fields, md = tiny
    cfg = JaxFctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=DT,
                          flux_eps=EPS, dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        out = fct_ale_step_pallas(
            pd, ps, cfg, {k: jnp.asarray(v, jnp.float32)
                          for k, v in fields.items()})
    p = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in out.items()}
    s = {k: torch.from_numpy(np.asarray(v, np.float32))
         for k, v in fields.items()}

    tmax, tmin = kernels.bounds_ref(md, s["fct_LO"], s["ttf"], vlimit)
    assert torch.equal(tmax, p["fct_ttf_max"])
    assert torch.equal(tmin, p["fct_ttf_min"])

    plus, minus, av_lim, av_res = kernels.limit_ref(
        md, s["fct_adf_v"], p["fct_ttf_max"], p["fct_ttf_min"],
        s["fct_adf_h"], DT, EPS, iter_yn)
    av_lim_ref = p["fct_adf_v_limited"] if iter_yn else p["fct_adf_v"]
    got = dict(fct_plus=plus, fct_minus=minus, adf_v_lim=av_lim)
    ref = dict(fct_plus=p["fct_plus"], fct_minus=p["fct_minus"],
               adf_v_lim=av_lim_ref)
    if iter_yn:
        got["adf_v_res"], ref["adf_v_res"] = av_res, p["fct_adf_v"]
    else:
        assert av_res is None

    o1, o2, ah_lim, ah_res = kernels.update_fused_ref(
        md, p["fct_plus"], p["fct_minus"], av_lim_ref, s["fct_adf_h"],
        s["ttf"], s["hnode"], s["hnode_new"], s["fct_LO"],
        s["del_ttf_advvert"], s["del_ttf_advhoriz"], DT, iter_yn)
    if iter_yn:
        assert o2 is None
        got.update(fct_LO=o1, adf_h_lim=ah_lim, adf_h_res=ah_res)
        ref.update(fct_LO=p["fct_LO"], adf_h_lim=p["fct_adf_h_limited"],
                   adf_h_res=p["fct_adf_h"])
    else:
        assert ah_res is None
        got.update(del_ttf_advvert=o1, del_ttf_advhoriz=o2, adf_h_lim=ah_lim)
        ref.update(del_ttf_advvert=p["del_ttf_advvert"],
                   del_ttf_advhoriz=p["del_ttf_advhoriz"],
                   adf_h_lim=p["fct_adf_h"])
    for k in ref:
        assert got[k].dtype == torch.float32, k
        assert got[k].shape == ref[k].shape, k
        err = _relerr(got[k], ref[k])
        assert err <= F32_RELERR, f"{k}: relerr {err:.2e}"


@pytest.mark.parametrize("iter_yn", [False, True])
def test_limit_ref_b3v_mask_follows_stages(iter_yn):
    """A nonzero vertical flux at z = nlev_nod - 1 passes through b3v
    unlimited, as in stages.b3_vertical and the numpy oracle (the Pallas K2
    limits rows z < nlev_nod and would zero it)."""
    mesh = generate_planar_mesh(preset="small")
    fields = random_fields(mesh, seed=2)
    rows, cols = mesh.nlev_nod - 1, np.arange(mesh.n_nodes)
    av = fields["fct_adf_v"].copy()
    av[rows, cols] = np.linspace(-1.0, 1.0, mesh.n_nodes) + 0.25
    rng = np.random.default_rng(5)
    tmax = np.abs(rng.standard_normal(fields["ttf"].shape))
    tmin = -np.abs(rng.standard_normal(fields["ttf"].shape))

    md = build_mesh_data(mesh, torch.float64, "cpu")
    t = torch.from_numpy
    plus, minus, av_lim, av_res = kernels.limit_ref(
        md, t(av), t(tmax), t(tmin), t(fields["fct_adf_h"]), DT, EPS,
        iter_yn)
    assert torch.equal(av_lim[rows, cols], t(av)[rows, cols])

    jmd = jax_mesh_data(jax_planar_mesh(preset="small"), dtype=jnp.float64)
    j = jnp.asarray
    jp, jm = jax_stages.b1_vertical(jmd, j(av))
    jp, jm = jax_stages.b1_horizontal(jmd, jp, jm, j(fields["fct_adf_h"]))
    jp, jm = jax_stages.b2(jmd, jp, jm, j(tmax), j(tmin), DT, EPS)
    jv, jr = jax_stages.b3_vertical(jmd, jp, jm, j(av), iter_yn)
    for a, b, name in ((plus, jp, "fct_plus"), (minus, jm, "fct_minus"),
                       (av_lim, jv, "adf_v_lim"), (av_res, jr, "adf_v_res")):
        if b is None:
            assert a is None
            continue
        masked_allclose(a.numpy(), np.asarray(b), msg=name)


@pytest.mark.parametrize("vlimit", [1, 2, 3])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_cuda_step_on_cpu_matches_torch_step(vlimit, iter_yn):
    """fct_ale_step_cuda on CPU tensors runs the wrappers' plain versions:
    the same keys and values as fct_ale_step (f64), and no launch."""
    mesh = generate_planar_mesh(preset="small")
    md = build_mesh_data(mesh, torch.float64, "cpu")
    cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=DT,
                       dtype=torch.float64)
    state = {k: torch.from_numpy(v)
             for k, v in random_fields(mesh, seed=9).items()}
    kernels.reset_launch_counts()
    got = fct_ale_step_cuda(md, cfg, state)
    ref = fct_ale_step(md, cfg, state)
    assert got.keys() == ref.keys()
    for k in ref:
        masked_allclose(got[k].numpy(), ref[k].numpy(), msg=k)
    assert kernels.launch_counts() == {"bounds": 0, "limit": 0,
                                       "limit_fused": 0,
                                       "update_fused": 0, "b3h": 0,
                                       "b3h_fixup": 0, "update": 0,
                                       "update_fixup": 0, "a2": 0,
                                       "stress2rhs": 0}
    assert build.library.cache_info().currsize == 0, \
        "the CPU path must not build or load the CUDA library"


def test_wrappers_raise_off_cpu_and_cuda():
    """A wrapper runs its plain version only for CPU tensors; any other
    device is checked and refused before a launch (here: meta tensors)."""
    mesh = generate_planar_mesh(preset="toy")
    md = build_mesh_data(mesh, torch.float32, "meta")
    L, N, Ed = md.n_layers, md.n_nodes, md.n_edges
    node = torch.empty((L, N), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.bounds(md, node, node, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.limit(md, torch.empty((L + 1, N), device="meta"), node,
                      node, torch.empty((L, Ed), device="meta"), DT, EPS,
                      False)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.update_fused(md, node, node,
                             torch.empty((L + 1, N), device="meta"),
                             torch.empty((L, Ed), device="meta"), node,
                             node, node, node, node, node, DT, False)
    # CPU tensors against mesh data elsewhere are refused as well
    with pytest.raises(ValueError):
        kernels.bounds(md, torch.zeros(L, N), torch.zeros(L, N), 1)


def test_nvcc_command_targets_sm90a_without_fast_math(tmp_path):
    for source in build.SOURCES:
        cmd = build.nvcc_command(source, tmp_path / "lib.so")
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined
        assert "--use_fast_math" not in joined
        assert "-use_fast_math" not in joined
        for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
            assert flag in cmd
        assert str(build.CSRC / source) in cmd
        assert build.library_path(source).parent == build.BUILD_DIR
    assert set(build.SOURCES) == {"fct_ale.cu", "stress2rhs.cu"}


def test_library_name_is_keyed_by_source_hash(tmp_path, monkeypatch):
    """An edit of a source changes its library's name, so it rebuilds;
    the other source's library keeps its name."""
    src = tmp_path / "csrc"
    src.mkdir()
    for source in build.SOURCES:
        (src / source).write_text((build.CSRC / source).read_text())
    monkeypatch.setattr(build, "CSRC", src)
    before = {s: build.library_path(s) for s in build.SOURCES}
    text = (src / "fct_ale.cu").read_text()
    (src / "fct_ale.cu").write_text(text + "\n// edit\n")
    after = {s: build.library_path(s) for s in build.SOURCES}
    assert before["fct_ale.cu"] != after["fct_ale.cu"]
    assert before["fct_ale.cu"].parent == after["fct_ale.cu"].parent
    assert before["stress2rhs.cu"] == after["stress2rhs.cu"]


def _cu_int(src: str, name: str) -> int:
    import re
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _cu_occupancy_ids(src: str) -> tuple:
    """OccupancyKernel's enumerators in order, kOccUpdateFused ->
    update_fused."""
    import re
    body = re.search(r"enum OccupancyKernel \{(.*?)\}", src, re.S).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    return tuple(re.sub(r"(?<!^)(?=[A-Z])", "_", n[len("kOcc"):]).lower()
                 for n in names)


# each Python copy of a constant of a kernel source: the copy, the source,
# and how to read the original there
CU_COPIES = {
    "kTileNodes": (lambda: TILE_NODES, "fct_ale.cu",
                   lambda s: _cu_int(s, "kTileNodes")),
    "kLimitLevels": (lambda: LIMIT_LEVELS, "fct_ale.cu",
                     lambda s: _cu_int(s, "kLimitLevels")),
    "kLimitFusedLevels": (lambda: LIMIT_FUSED_LEVELS, "fct_ale.cu",
                          lambda s: _cu_int(s, "kLimitFusedLevels")),
    "kUpdateSplitLevels": (lambda: UPDATE_SPLIT_LEVELS, "fct_ale.cu",
                           lambda s: _cu_int(s, "kUpdateSplitLevels")),
    "kMaxWideThreads": (lambda: kernels.MAX_WIDE_THREADS, "fct_ale.cu",
                        lambda s: _cu_int(s, "kMaxWideThreads")),
    "kFixThreads": (lambda: kernels.FIX_THREADS, "fct_ale.cu",
                    lambda s: _cu_int(s, "kFixThreads")),
    "OccupancyKernel": (lambda: kernels.OCCUPANCY, "fct_ale.cu",
                        _cu_occupancy_ids),
    "kLanesPerNode": (lambda: kernels.S2R_LANES, "stress2rhs.cu",
                      lambda s: _cu_int(s, "kLanesPerNode")),
}


@pytest.mark.parametrize("name", sorted(CU_COPIES))
def test_python_copies_of_cuda_constants(name):
    """TILE_NODES sizes H-K34's shared memory (MeshData.tile_edges),
    LIMIT_LEVELS, LIMIT_FUSED_LEVELS and UPDATE_SPLIT_LEVELS are the level
    chunks of H-K2, H-K12 and H-K4 (chip_smoke.py's layer counts straddle
    each, as the chunk tests below do), MAX_WIDE_THREADS refuses what
    with_config refuses, FIX_THREADS is the one block size of H-K4's FIX
    form, OCCUPANCY names the occupancy query's kernel ids,
    and S2R_LANES is H-S2R's lanes per node: each must equal its
    source's."""
    copy, source, original = CU_COPIES[name]
    src = (build.CSRC / source).read_text()
    assert copy() == original(src)


def test_launcher_argtypes_cover_every_launcher():
    """Each C launcher's ctypes signature: pointers and the stream as
    c_void_p (never a 32-bit int), as the launchers in csrc/ take, and
    each launcher is defined, as _f32 and _f64, in the source that
    SOURCES names for it."""
    import ctypes
    import re

    macros = {"fct_bounds": "FCT_BOUNDS_ARGS", "fct_limit": "FCT_LIMIT_ARGS",
              "fct_limit_fused": "FCT_LIMIT_FUSED_ARGS",
              "fct_update_fused": "FCT_UPDATE_ARGS",
              "fct_b3h": "FCT_B3H_ARGS",
              "fct_b3h_fixup": "FCT_B3H_FIXUP_ARGS",
              "fct_update": "FCT_UPDATE_SPLIT_ARGS",
              "fct_update_fixup": "FCT_UPDATE_FIXUP_ARGS",
              "fct_a2": "FCT_A2_ARGS",
              "fct_occupancy": "FCT_OCCUPANCY_ARGS",
              "stress2rhs": "S2R_ARGS"}
    named = [n for names in build.SOURCES.values() for n in names]
    assert sorted(named) == sorted(build.ARGTYPES) == sorted(macros)
    for source, names in build.SOURCES.items():
        src = (build.CSRC / source).read_text()
        for name in names:
            argtypes = build.ARGTYPES[name]
            body = re.search(rf"#define {macros[name]}(.*?)\n#define", src,
                             re.S).group(1)
            params = [p.strip() for p in body.replace("\\", " ").split(",")]
            assert len(params) == len(argtypes), name
            for p, t in zip(params, argtypes):
                want = (ctypes.c_void_p if "*" in p else
                        ctypes.c_double if p.startswith("double") else
                        ctypes.c_int)
                assert t is want, f"{name}: {p}"
            for suffix in ("_f32", "_f64"):
                assert re.search(rf"int {name}{suffix}\(", src), name


# --------------------------------------------------------------------------
# H-K12 limit_fused, the four single-device forms, H-A2 a2
# --------------------------------------------------------------------------

FUSED_RELERR = 2e-5  # tests/test_packed.py's bound for the fused K1+K2 step


@pytest.fixture(scope="module")
def small_fused():
    mesh = generate_planar_mesh(preset="small")
    pd, ps = build_pallas_data(jax_planar_mesh(preset="small"), fuse_k12=True)
    assert ps.fuse_k12 and ps.a3f_dia_D and ps.pack_K
    return mesh, pd, ps


@pytest.mark.parametrize("iter_yn", [False, True])
def test_limit_fused_matches_jax_fused_step(small_fused, iter_yn):
    """The JAX step with its fused K1+K2 kernel (limit_fused_pallas, in TPU
    interpret mode, as tests/test_packed.py runs it): limit_fused_ref gives
    its bounds, factors and limited vertical flux, and fct_ale_step_cuda
    (fuse_k12=True, both fuse_k34) on CPU tensors its every output, f32,
    relerr <= 2e-5."""
    mesh, pd, ps = small_fused
    fields = random_fields(mesh, seed=13, dtype=np.float32)
    jcfg = JaxFctAleConfig(dt=0.6, iter_yn=iter_yn, dtype=jnp.float32,
                           flux_eps=EPS)
    with pltpu.force_tpu_interpret_mode():
        out = fct_ale_step_pallas(pd, ps, jcfg, {
            k: jnp.asarray(v, jnp.float32) for k, v in fields.items()})
    p = {k: np.asarray(v, np.float32) for k, v in out.items()}
    s = {k: torch.from_numpy(v) for k, v in fields.items()}
    md = build_mesh_data(mesh, torch.float32, "cpu")
    got = kernels.limit_fused_ref(md, s["fct_LO"], s["ttf"], s["fct_adf_v"],
                                  s["fct_adf_h"], 1, 0.6, EPS, iter_yn)
    want = [p["fct_ttf_max"], p["fct_ttf_min"], p["fct_plus"],
            p["fct_minus"],
            p["fct_adf_v_limited"] if iter_yn else p["fct_adf_v"]]
    want.append(p["fct_adf_v"] if iter_yn else None)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert _relerr(g, w) <= FUSED_RELERR
    cfg = FctAleConfig(dt=0.6, iter_yn=iter_yn, flux_eps=EPS)
    for fuse_k34 in (True, False):
        step = fct_ale_step_cuda(md, cfg, s, fuse_k12=True,
                                 fuse_k34=fuse_k34)
        assert step.keys() == p.keys()
        for k in p:
            assert _relerr(step[k], p[k]) <= FUSED_RELERR, k


@pytest.mark.parametrize("vlimit", [1, 2, 3])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_limit_fused_ref_matches_oracle_f64(vlimit, iter_yn):
    from fesom2_accelerate_tpu.ops import oracle

    mesh = generate_planar_mesh(preset="small")
    fields = random_fields(mesh, seed=9)
    ref = oracle.fct_ale_step(jax_planar_mesh(preset="small"), fields,
                              vlimit=vlimit, iter_yn=iter_yn, dt=DT,
                              flux_eps=EPS)
    md = build_mesh_data(mesh, torch.float64, "cpu")
    t = {k: torch.from_numpy(v) for k, v in fields.items()}
    got = kernels.limit_fused_ref(md, t["fct_LO"], t["ttf"], t["fct_adf_v"],
                                  t["fct_adf_h"], vlimit, DT, EPS, iter_yn)
    names = ["fct_ttf_max", "fct_ttf_min", "fct_plus", "fct_minus",
             "fct_adf_v_limited" if iter_yn else "fct_adf_v"]
    for g, name in zip(got, names):
        masked_allclose(g.numpy(), ref[name], msg=name)
    if iter_yn:
        masked_allclose(got[5].numpy(), ref["fct_adf_v"], msg="adf_v_res")
    else:
        assert got[5] is None


@pytest.mark.parametrize("fuse_k12", [False, True])
@pytest.mark.parametrize("fuse_k34", [False, True])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_step_forms_on_cpu_match_torch_step(fuse_k12, fuse_k34, iter_yn):
    """Each of the four forms K1->K2 or K12, then K34 or K3->K4, on CPU
    tensors: the keys and values (f64, 1e-12) of fct_ale_step, and no
    launch."""
    mesh = generate_planar_mesh(preset="small")
    md = build_mesh_data(mesh, torch.float64, "cpu")
    cfg = FctAleConfig(vlimit=3, iter_yn=iter_yn, dt=DT, dtype=torch.float64)
    state = {k: torch.from_numpy(v)
             for k, v in random_fields(mesh, seed=4).items()}
    kernels.reset_launch_counts()
    got = fct_ale_step_cuda(md, cfg, state, fuse_k12=fuse_k12,
                            fuse_k34=fuse_k34, threads=256)
    ref = fct_ale_step(md, cfg, state)
    assert got.keys() == ref.keys()
    for k in ref:
        masked_allclose(got[k].numpy(), ref[k].numpy(), msg=k)
    assert sum(kernels.launch_counts().values()) == 0


def test_a2_ref_matches_oracle_and_pallas():
    """a2_ref against the oracle's a2 (f64, bit-exact), and against the JAX
    a2_pallas in interpret mode on the inputs tune_a2 builds (bounds from
    f32 fields, computed in f64, rounded to f32): within tune_a2's 1e-5,
    and in fact exact (max and min of the same three f32 values)."""
    from fesom2_accelerate_tpu.ops import oracle
    from fesom2_accelerate_tpu.ops.pallas import kernels as jax_kernels

    jmesh = jax_planar_mesh(preset="small")
    mesh = generate_planar_mesh(preset="small")
    fields = random_fields(mesh, seed=0, dtype=np.float32)
    mk = oracle.masks(jmesh)
    tmax64, tmin64 = oracle.a1(jmesh, mk,
                               fields["fct_LO"].astype(np.float64),
                               fields["ttf"].astype(np.float64))
    ref = oracle.a2(jmesh, mk, tmax64, tmin64)
    md = build_mesh_data(mesh, torch.float64, "cpu")
    got = kernels.a2_ref(md, torch.from_numpy(tmax64),
                         torch.from_numpy(tmin64), 1e3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)

    pd, ps = build_pallas_data(jmesh, tile=128)
    L, Lp = ps.L, ps.Lp
    src = np.zeros((2 * Lp, ps.Np), np.float32)
    src[:L, :ps.N] = tmax64
    src[Lp:Lp + L, :ps.N] = tmin64
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(jax_kernels.a2_pallas(
            jnp.asarray(src), pd.a2_lidx, pd.a2_wb, pd.nlev_elem_row,
            tile=128, nblocks=ps.a2_nblocks, bignumber=1e3))
    md32 = build_mesh_data(mesh, torch.float32, "cpu")
    got = kernels.a2_ref(md32, torch.from_numpy(src[:L, :ps.N]),
                         torch.from_numpy(src[Lp:Lp + L, :ps.N]), 1e3)
    for g, w in zip(got, (out[:L, :ps.E], out[Lp:Lp + L, :ps.E])):
        assert _relerr(g, w) <= 1e-5
        np.testing.assert_array_equal(g.numpy(), w)


def test_new_wrappers_refuse_other_devices_and_block_sizes():
    """limit_fused and a2 refuse any device but the CPU (plain version)
    and CUDA (the kernel); every wrapper refuses a block size that has no
    kernel instance, on any device."""
    mesh = generate_planar_mesh(preset="toy")
    md = build_mesh_data(mesh, torch.float32, "meta")
    L, N, Ed = md.n_layers, md.n_nodes, md.n_edges
    node = torch.empty((L, N), device="meta")
    iface = torch.empty((L + 1, N), device="meta")
    edge = torch.empty((L, Ed), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.limit_fused(md, node, node, iface, edge, 1, DT, EPS, False)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.a2(md, node, node, 1e3)

    cpu = build_mesh_data(mesh, torch.float32, "cpu")
    s = {k: torch.from_numpy(v)
         for k, v in random_fields(mesh, seed=1, dtype=np.float32).items()}
    calls = {
        "bounds": lambda t: kernels.bounds(cpu, s["fct_LO"], s["ttf"], 1,
                                           threads=t),
        "limit_fused": lambda t: kernels.limit_fused(
            cpu, s["fct_LO"], s["ttf"], s["fct_adf_v"], s["fct_adf_h"], 1,
            DT, EPS, False, threads=t),
        "b3h": lambda t: kernels.b3h(cpu, s["ttf"], s["ttf"],
                                     s["fct_adf_h"], False, threads=t),
        "a2": lambda t: kernels.a2(cpu, s["ttf"], s["ttf"], 1e3, threads=t),
    }
    for name, call in calls.items():
        for t in kernels.THREADS:
            call(t)
        with pytest.raises(ValueError, match="threads"):
            call(100)
    # rows of more than 8 slots have node-kernel instances up to 128 threads
    import dataclasses

    wide = dataclasses.replace(cpu, nd_idx=torch.zeros((N, 12),
                                                       dtype=torch.int32))
    for t in (256, 512):
        with pytest.raises(ValueError, match="slots"):
            kernels.bounds(wide, s["fct_LO"], s["ttf"], 1, threads=t)
    assert sum(kernels.launch_counts().values()) == 0


def test_solver_form_keywords():
    """fuse_k12 and fuse_k34 choose the form of backend='cuda' (by default
    K12 -> K3 -> K4); backend='torch' (also the default on the CPU)
    refuses any value but the default, and 'cuda' still needs a CUDA
    device.  The block size is no keyword of the solver."""
    from fesom2_accelerate_tpu_torch import FctAleSolver

    mesh = generate_planar_mesh(preset="toy")
    with pytest.raises(TypeError):
        FctAleSolver(mesh, FctAleConfig(), backend="torch", device="cpu",
                     threads=128)
    for kw in (dict(fuse_k12=False), dict(fuse_k34=True),
               dict(fuse_k12=False, fuse_k34=True)):
        with pytest.raises(ValueError, match="backend='torch'"):
            FctAleSolver(mesh, FctAleConfig(), backend="torch",
                         device="cpu", **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        FctAleSolver(mesh, FctAleConfig(), backend="cuda", device="cpu",
                     fuse_k12=False)
    with pytest.raises(ValueError, match="backend='torch'"):
        FctAleSolver(mesh, FctAleConfig(), device="cpu", fuse_k12=False)
    sv = FctAleSolver(mesh, FctAleConfig(), backend="torch", device="cpu",
                      fuse_k12=True, fuse_k34=False)
    assert (sv.fuse_k12, sv.fuse_k34) == (True, False)


def test_ptxas_report_reads_each_instance():
    """build.ptxas_report reads the kernel, dtype, template ints, the
    tracer-axis flag, H-K4's FIX flag, registers and spills of each
    instance from an nvcc -Xptxas -v log."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN36_GLOBAL__N__f6935f"
        "_10_fct_ale_cu_7df9e15018limit_fused_kernelIdLi8ELi512EEEvPKT_'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _ZN36_GLOBAL__N__x",
        "    16 bytes stack frame, 8 bytes spill stores, 24 bytes spill "
        "loads",
        "ptxas info    : Used 64 registers, used 0 barriers, 400 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function '_ZN36_GLOBAL__N__f6935f"
        "_10_fct_ale_cu_7df9e1509a2_kernelIfLi128EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN36_GLOBAL__N__y",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 20 registers, used 0 barriers, 392 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function '_ZN36_GLOBAL__N__f6935f"
        "_10_fct_ale_cu_7df9e15016b3h_fixup_kernelIfLi128ELb1EEEvPKT_' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN36_GLOBAL__N__z",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 22 registers, used 0 barriers, 400 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function '_ZN36_GLOBAL__N__f6935f"
        "_10_fct_ale_cu_7df9e15013update_kernelIfLi8ELi128ELb0ELb1EEEvPKT_'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _ZN36_GLOBAL__N__w",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 44 registers, used 1 barriers, 456 bytes "
        "cmem[0]",
    ])
    assert build.ptxas_report(log) == [
        dict(kernel="limit_fused_kernel", dtype="double", params=(8, 512),
             tracers=False, fix=False, stack=16, spill_stores=8, spill_loads=24,
             registers=64),
        dict(kernel="a2_kernel", dtype="float", params=(128,),
             tracers=False, fix=False, stack=0, spill_stores=0, spill_loads=0,
             registers=20),
        dict(kernel="b3h_fixup_kernel", dtype="float", params=(128,),
             tracers=True, fix=False, stack=0, spill_stores=0,
             spill_loads=0, registers=22),
        dict(kernel="update_kernel", dtype="float", params=(8, 128),
             tracers=False, fix=True, stack=0, spill_stores=0,
             spill_loads=0, registers=44),
    ]


# --------------------------------------------------------------------------
# H-K2 limit and H-K4 update: the plain versions at layer counts that
# straddle each kernel's level chunk
# --------------------------------------------------------------------------


def _straddling(lc: int) -> tuple:
    """Layer counts around a level chunk of lc: L = 2, lc - 1, lc, lc + 1
    and 2 lc + 1 (chip_smoke.py holds each kernel against its plain version
    at these)."""
    return (2, lc - 1, lc, lc + 1, 2 * lc + 1)


CHUNK_CASES = ([("limit", n) for n in _straddling(LIMIT_LEVELS)]
               + [("update", n) for n in _straddling(UPDATE_SPLIT_LEVELS)])


def _layered_meshes(n_layers: int) -> tuple:
    """(port mesh, JAX mesh) of n_layers layers on tiny's 8 x 6 lattice:
    the generator's bathymetry, or, below the 3 layers it takes, tiny's
    elements with every element n_layers deep."""
    from fesom2_accelerate_tpu.mesh import (
        build_mesh_from_elements as jax_build_mesh,
    )
    from fesom2_accelerate_tpu_torch.mesh import build_mesh_from_elements

    nl = n_layers + 1
    if nl >= 4:
        return (generate_planar_mesh(nx=8, ny=6, nl=nl),
                jax_planar_mesh(nx=8, ny=6, nl=nl))
    tiny = generate_planar_mesh(preset="tiny")
    args = (tiny.elem_nodes, np.full(tiny.n_elems, nl), nl, tiny.node_xy)
    return build_mesh_from_elements(*args), jax_build_mesh(*args)


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("kernel,n_layers", CHUNK_CASES)
def test_limit_and_update_plain_straddling_chunks(kernel, n_layers, iter_yn):
    """limit_ref (b1v, b1h, b2, b3v) and update_ref (stage c) against the
    JAX package's stages and the numpy oracle, f64, 1e-12, on meshes whose
    layer counts straddle the level chunk of H-K2 (LIMIT_LEVELS) or H-K4
    (UPDATE_SPLIT_LEVELS)."""
    from fesom2_accelerate_tpu.ops import oracle

    mesh, jmesh = _layered_meshes(n_layers)
    assert mesh.n_layers == jmesh.n_layers == n_layers
    fields = random_fields(mesh, seed=n_layers)
    md = build_mesh_data(mesh, torch.float64, "cpu")
    jmd = jax_mesh_data(jmesh, dtype=jnp.float64)
    mk = oracle.masks(jmesh)
    t = {k: torch.from_numpy(v) for k, v in fields.items()}
    j = {k: jnp.asarray(v) for k, v in fields.items()}
    f = fields
    if kernel == "limit":
        rng = np.random.default_rng(n_layers)
        tmax = np.abs(rng.standard_normal(f["ttf"].shape))
        tmin = -np.abs(rng.standard_normal(f["ttf"].shape))
        got = kernels.limit_ref(md, t["fct_adf_v"], torch.from_numpy(tmax),
                                torch.from_numpy(tmin), t["fct_adf_h"], DT,
                                EPS, iter_yn)
        jp, jm = jax_stages.b1_vertical(jmd, j["fct_adf_v"])
        jp, jm = jax_stages.b1_horizontal(jmd, jp, jm, j["fct_adf_h"])
        jp, jm = jax_stages.b2(jmd, jp, jm, jnp.asarray(tmax),
                               jnp.asarray(tmin), DT, EPS)
        jax_out = (jp, jm) + tuple(jax_stages.b3_vertical(
            jmd, jp, jm, j["fct_adf_v"], iter_yn))
        op, om = oracle.b1_vertical(jmesh, mk, f["fct_adf_v"])
        op, om = oracle.b1_horizontal(jmesh, mk, op, om, f["fct_adf_h"])
        op, om = oracle.b2(jmesh, mk, op, om, tmax, tmin, DT, EPS)
        ov = oracle.b3_vertical(jmesh, mk, op, om, f["fct_adf_v"], iter_yn)
        oracle_out = (op, om) + (ov if iter_yn else (ov, None))
        names = ("fct_plus", "fct_minus", "adf_v_lim", "adf_v_res")
    else:
        node = (f["ttf"], f["hnode"], f["hnode_new"], f["fct_LO"],
                f["del_ttf_advvert"], f["del_ttf_advhoriz"])
        got = kernels.update_ref(md, t["fct_adf_v"], t["fct_adf_h"],
                                 *(torch.from_numpy(a) for a in node), DT,
                                 iter_yn)
        if iter_yn:
            jax_out = (jax_stages.c_update_LO(
                jmd, j["fct_LO"], j["fct_adf_v"], j["fct_adf_h"],
                j["hnode_new"], DT), None)
            oracle_out = (oracle.c_update_LO(
                jmesh, mk, f["fct_LO"], f["fct_adf_v"], f["fct_adf_h"],
                f["hnode_new"], DT), None)
        else:
            jax_out = jax_stages.c_update_solution(
                jmd, *(jnp.asarray(a) for a in node[:4]), j["fct_adf_v"],
                j["fct_adf_h"], *(jnp.asarray(a) for a in node[4:]), DT)
            oracle_out = oracle.c_update_solution(
                jmesh, mk, *node[:4], f["fct_adf_v"], f["fct_adf_h"],
                *node[4:], DT)
        names = ("o1", "o2")
    assert len(got) == len(jax_out) == len(oracle_out) == len(names)
    for name, g, jx, o in zip(names, got, jax_out, oracle_out):
        if o is None:
            assert g is None and jx is None, name
            continue
        assert g.dtype == torch.float64, name
        masked_allclose(g.numpy(), np.asarray(jx), msg=f"{name} vs stages")
        masked_allclose(g.numpy(), o, msg=f"{name} vs oracle")
