"""PyTorch port: multi-tracer batching, on the CPU.

Tb = 3 tracers (2 on the sharded path), each with its own
``random_fields(seed=20 + t)`` and ``hnode``/``hnode_new`` shared from
tracer 0, as tests/test_packed.py:212-218 makes them:

* (a) ``fct_ale_step_cuda_batched`` on CPU tensors (every kernel wrapper
  runs its plain version) against the JAX ``fct_ale_step_pallas_batched``
  in TPU interpret mode: ``fct_ttf_max/min`` bit-equal, every other output
  within relerr 1e-6 (another summation order, f32 rounding);
* (b) each of the seven wrappers with a tracer axis against Tb
  single-tracer calls, bit for bit;
* (c) ``FctAleSolver.run_tracers`` against Tb single-tracer ``run``s;
* (d) the sharded CUDA phases with a tracer axis on 8 CPU parts against the
  JAX ``ShardedFctAleSolver(backend="pallas", tracers=2)`` (interpret mode,
  relerr 2e-6, tests/test_sharded.py) and against the port's own
  single-tracer sharded step, bit for bit;
* (e) the tracer-aware ``init_state`` -> ``gather_state`` round trip;
* (f) the refusals, and a batched K12 step against Tb single-tracer ones;
  (g) ``profiling.kernel_io(tracers=)``.

The CUDA kernels run only on a GPU (``chip_smoke.py`` phase 8 holds each
against Tb launches at Tb = 1 there); the CUDA solvers need a card, so
(c) and (e) give a CPU solver the CUDA backend's tracer step or tracer
count, as tests/test_torch_model.py gives it the CUDA step function."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fesom2_accelerate_tpu.config import FctAleConfig as JaxFctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.ops.pallas import kernels as pallas_kernels
from fesom2_accelerate_tpu.ops.pallas.step import (
    build_pallas_data,
    fct_ale_step_pallas_batched,
)
from fesom2_accelerate_tpu.parallel import (
    ShardedFctAleSolver as JaxShardedFctAleSolver,
)
from fesom2_accelerate_tpu_torch import (
    FctAleConfig,
    FctAleSolver,
    ShardedFctAleSolver,
)
from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu_torch.ops.cuda import build, kernels
from fesom2_accelerate_tpu_torch.ops.cuda.step import (
    BATCH_SHARED,
    fct_ale_step_cuda,
    fct_ale_step_cuda_batched,
    pre_exchange,
)
from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data
from fesom2_accelerate_tpu_torch.parallel.step_sharded import (
    sharded_fct_ale_step_cuda,
)
from fesom2_accelerate_tpu_torch.runtime import profiling

DT, EPS = 0.7, 1e-7
TB = 3
F32_RELERR = 1e-6  # tests/test_torch_kernels.py
SHARDED_RELERR = 2e-6  # tests/test_sharded.py


def _relerr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def tracer_fields(mesh, tb: int, dtype=np.float32, seed0: int = 20):
    """(per-tracer field dicts, the batched dict): tracer t from
    ``random_fields(seed=seed0 + t)``, hnode/hnode_new from tracer 0."""
    per = [random_fields(mesh, seed=seed0 + t, dtype=dtype)
           for t in range(tb)]
    for f in per[1:]:
        f.update({k: per[0][k] for k in BATCH_SHARED})
    batched = {k: per[0][k] if k in BATCH_SHARED
               else np.stack([f[k] for f in per]) for k in per[0]}
    return per, batched


def _tensors(d: dict, dtype=None) -> dict:
    return {k: torch.tensor(v, dtype=dtype) for k, v in d.items()}


def _tracer(state: dict, t: int) -> dict:
    """Tracer t's single-tracer state of a batched one."""
    return {k: v if k in BATCH_SHARED else v[t] for k, v in state.items()}


# --------------------------------------------------------------------------
# (a) the batched step against the JAX batched Pallas step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("preset,vlimit,iter_yn", [
    ("tiny", 1, False), ("tiny", 1, True), ("tiny", 3, False),
    ("tiny", 3, True), ("small", 1, False), ("small", 3, True)])
def test_batched_step_matches_jax_pallas_batched(preset, vlimit, iter_yn):
    mesh = generate_planar_mesh(preset=preset)
    pd, ps = build_pallas_data(jax_planar_mesh(preset=preset))
    assert ps.pack_K and ps.a3f_dia_D, "the JAX batched grids need both"
    _, batched = tracer_fields(mesh, TB)
    jcfg = JaxFctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=DT,
                           flux_eps=EPS, dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        jout = fct_ale_step_pallas_batched(
            pd, ps, jcfg, {k: jnp.asarray(v) for k, v in batched.items()})

    md = build_mesh_data(mesh, torch.float32, "cpu")
    cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=DT, flux_eps=EPS,
                       dtype=torch.float32)
    kernels.reset_launch_counts()
    out = fct_ale_step_cuda_batched(md, cfg, _tensors(batched))
    assert not any(kernels.launch_counts().values())
    assert out.keys() == jout.keys()
    for k, v in jout.items():
        want = np.asarray(v)
        got = out[k].numpy()
        assert got.shape == want.shape, k
        if k in ("fct_ttf_max", "fct_ttf_min"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            err = _relerr(got, want)
            assert err <= F32_RELERR, f"{k}: relerr {err:.2e}"


# --------------------------------------------------------------------------
# (b) each wrapper with a tracer axis against Tb single-tracer calls
# --------------------------------------------------------------------------


def _node_in(s):
    return (s["ttf"], s["hnode"], s["hnode_new"], s["fct_LO"],
            s["del_ttf_advvert"], s["del_ttf_advhoriz"])


# each wrapper on a state holding its inputs (batched or one tracer's)
CALLS = {
    "bounds": lambda md, s, it: kernels.bounds(md, s["fct_LO"], s["ttf"], 3),
    "limit": lambda md, s, it: kernels.limit(
        md, s["fct_adf_v"], s["tmax"], s["tmin"], s["fct_adf_h"], DT, EPS,
        it),
    "update_fused": lambda md, s, it: kernels.update_fused(
        md, s["plus"], s["minus"], s["avl"], s["fct_adf_h"], *_node_in(s),
        DT, it),
    "b3h": lambda md, s, it: kernels.b3h(md, s["plus"], s["minus"],
                                         s["fct_adf_h"], it),
    # other factors than K3's, as after an exchange; in place into copies
    "b3h_fixup": lambda md, s, it: kernels.b3h_fixup(
        md, 0.75 * s["plus"], 0.75 * s["minus"], s["fct_adf_h"],
        s["lim"].clone(), s["res"].clone() if it else None, s["ids"], it),
    "update": lambda md, s, it: kernels.update(md, s["avl"], s["lim"],
                                               *_node_in(s), DT, it),
    "limit_fused": lambda md, s, it: kernels.limit_fused(
        md, s["fct_LO"], s["ttf"], s["fct_adf_v"], s["fct_adf_h"], 2, DT,
        EPS, it),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_batched_wrapper_is_tb_single_calls(name):
    mesh = generate_planar_mesh(preset="small")
    md = build_mesh_data(mesh, torch.float64, "cpu")
    _, batched = tracer_fields(mesh, TB, np.float64)
    ids = torch.arange(0, mesh.n_edges, 3, dtype=torch.int32)
    for iter_yn in (False, True):
        s = _tensors(batched)
        s["tmax"], s["tmin"] = kernels.bounds_ref(md, s["fct_LO"], s["ttf"],
                                                  1)
        s["plus"], s["minus"], s["avl"], _ = kernels.limit_ref(
            md, s["fct_adf_v"], s["tmax"], s["tmin"], s["fct_adf_h"], DT,
            EPS, iter_yn)
        s["lim"], s["res"] = kernels.b3h_ref(md, s["plus"], s["minus"],
                                             s["fct_adf_h"], iter_yn)
        shared = set(BATCH_SHARED)
        if not iter_yn:
            shared.add("res")  # None
        got = CALLS[name](md, dict(s, ids=ids), iter_yn)
        for t in range(TB):
            one = {k: v if k in shared else v[t] for k, v in s.items()}
            want = CALLS[name](md, dict(one, ids=ids), iter_yn)
            assert len(got) == len(want)
            for i, (g, w) in enumerate(zip(got, want)):
                if w is None:
                    assert g is None, f"{name}[{i}] iter={iter_yn}"
                    continue
                assert g.shape == (TB,) + w.shape
                assert torch.equal(g[t], w), \
                    f"{name}[{i}] tracer {t} iter={iter_yn}"


# --------------------------------------------------------------------------
# (c) FctAleSolver.run_tracers against Tb single-tracer runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fuse_k34", [True, False])
def test_run_tracers_is_tb_single_runs(fuse_k34):
    mesh = generate_planar_mesh(preset="small")
    per, batched = tracer_fields(mesh, TB)
    cfg = FctAleConfig(dt=0.5, flux_eps=EPS, iter_yn=False,
                       dtype=torch.float32)
    solver = FctAleSolver(mesh, cfg, backend="torch", device="cpu")
    # the CUDA backend's step functions, run here on CPU tensors
    solver._step_fn = functools.partial(fct_ale_step_cuda,
                                        fuse_k34=fuse_k34)
    solver._tracer_step_fn = functools.partial(fct_ale_step_cuda_batched,
                                               fuse_k34=fuse_k34)
    state = solver.init_state_tracers(batched)
    assert state["ttf"].shape == (TB, mesh.n_layers, mesh.n_nodes)
    assert state["hnode"].shape == (mesh.n_layers, mesh.n_nodes)
    out = solver.run_tracers(state, 3)
    assert out.keys() == state.keys()
    one = solver.step_tracers(state)
    for t in range(TB):
        ref = solver.run(solver.init_state(per[t]), 3)
        ref1 = solver.step(solver.init_state(per[t]))
        for k, v in ref.items():
            got = out[k] if k in BATCH_SHARED else out[k][t]
            assert torch.equal(got, v), f"run {k} tracer {t}"
        for k, v in ref1.items():
            got = one[k] if k in BATCH_SHARED else one[k][t]
            assert torch.equal(got, v), f"step {k} tracer {t}"


# --------------------------------------------------------------------------
# (d) the sharded CUDA phases with a tracer axis
# --------------------------------------------------------------------------


def _sharded_cuda(sh, state, fused):
    """One step of the CUDA backend's phases on the parts of the CPU solver
    ``sh`` (every wrapper runs its plain version) -> per-part state."""
    owned = None if fused else (sh.pm.H, sh.pm.H + sh.pm.B)
    parts = [{k: v[p] for k, v in state.items()} for p in range(sh.n_parts)]
    outs = sharded_fct_ale_step_cuda(sh.mds, sh.cfg, sh.halo_fill, parts,
                                     owned)
    return {k: [o[k] for o in outs] for k in outs[0]}


def _node_keys(iter_yn):
    keys = ["fct_plus", "fct_minus", "fct_ttf_max", "fct_ttf_min",
            "fct_adf_v"]
    return keys + (["fct_LO"] if iter_yn
                   else ["del_ttf_advvert", "del_ttf_advhoriz"])


@pytest.mark.parametrize("mode,iter_yn", [("split", False), ("split", True),
                                          ("fused", False)])
def test_sharded_tracers_match_jax_and_single_tracer(mode, iter_yn):
    Tb = 2
    mesh = generate_planar_mesh(preset="small")
    per, batched = tracer_fields(mesh, Tb)
    jcfg = JaxFctAleConfig(dt=DT, iter_yn=iter_yn, flux_eps=EPS,
                           dtype=jnp.float32)
    pallas_kernels.set_interpret(True)
    try:
        jsh = JaxShardedFctAleSolver(jax_planar_mesh(preset="small"), jcfg,
                                     backend="pallas", tracers=Tb,
                                     fused=(mode == "fused"))
        assert jsh.ps.pack_K > 0 and jsh.degraded == []
        jout = jsh.gather_state(jsh.step(jsh.init_state(batched)))
    finally:
        pallas_kernels.set_interpret(False)

    cfg = FctAleConfig(dt=DT, iter_yn=iter_yn, flux_eps=EPS,
                       dtype=torch.float32)
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 8)
    kernels.reset_launch_counts()
    out = _sharded_cuda(sh, sh.init_state(batched), mode == "fused")
    assert not any(kernels.launch_counts().values())
    got = sh.gather_state(out)
    L = mesh.n_layers
    for k in _node_keys(iter_yn) + ["fct_adf_h"]:
        rows = L + 1 if k == "fct_adf_v" else L
        assert got[k].shape[0] == Tb
        for t in range(Tb):
            err = _relerr(got[k][t], jout[k][t][:rows])
            assert err < SHARDED_RELERR, f"{k}[t={t}]: relerr {err:.2e}"

    # each tracer is the port's single-tracer sharded step, every part and
    # column (np.testing treats the 0/0 of empty pad columns as equal)
    for t in range(Tb):
        ref = _sharded_cuda(sh, sh.init_state(per[t]), mode == "fused")
        assert ref.keys() == out.keys()
        for k, v in ref.items():
            for p in range(sh.n_parts):
                g = out[k][p] if k in BATCH_SHARED else out[k][p][t]
                np.testing.assert_array_equal(g.numpy(), v[p].numpy(),
                                              err_msg=f"{k} part {p}")


# --------------------------------------------------------------------------
# (e) state movement with a tracer axis
# --------------------------------------------------------------------------


def test_sharded_init_gather_round_trip_with_tracers():
    mesh = generate_planar_mesh(preset="small")
    per, batched = tracer_fields(mesh, TB, np.float64)
    sh = ShardedFctAleSolver(mesh, FctAleConfig(dtype=torch.float64),
                             devices=["cpu"] * 4)
    sh.tracers = TB  # the CUDA backend's tracer count (its solver needs a
    # card); state movement is the same code on both backends
    state = sh.init_state(batched)
    n_local = sh.pm.n_local
    assert state["ttf"][0].shape == (TB, mesh.n_layers, n_local)
    assert state["fct_adf_v"][0].shape == (TB, mesh.n_layers + 1, n_local)
    assert state["hnode"][0].shape == (mesh.n_layers, n_local)
    back = sh.gather_state(state)
    for k, v in batched.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for t in range(TB):
        np.testing.assert_array_equal(sh.gather_node(state["ttf"])[t],
                                      per[t]["ttf"])
    with pytest.raises(ValueError, match="tracers"):
        sh.init_state(per[0])  # a per-tracer field without the axis
    with pytest.raises(ValueError, match="shared"):
        sh.init_state(dict(batched, hnode=batched["ttf"]))


# --------------------------------------------------------------------------
# (f) refusals
# --------------------------------------------------------------------------


def test_tracer_refusals():
    mesh = generate_planar_mesh(preset="tiny")
    md = build_mesh_data(mesh, torch.float32, "cpu")
    cfg = FctAleConfig(dt=DT, flux_eps=EPS)
    _, batched = tracer_fields(mesh, TB)
    s = _tensors(batched)
    # H-K12 takes the tracer axis: a batched K12 step, and its phase, are
    # Tb single-tracer ones
    out = fct_ale_step_cuda_batched(md, cfg, s, fuse_k12=True)
    pre = pre_exchange(md, cfg, s, fuse_k12=True)
    for t in range(TB):
        one = fct_ale_step_cuda(md, cfg, _tracer(s, t), fuse_k12=True)
        for k, v in one.items():
            got = out[k] if k in BATCH_SHARED else out[k][t]
            assert v is None and got is None or torch.equal(got, v), k
        assert torch.equal(pre["fct_plus"][t], one["fct_plus"])
    with pytest.raises(ValueError, match="batched"):
        fct_ale_step_cuda_batched(md, cfg, _tracer(s, 0))
    # tracer batching is the CUDA backend's
    solver = FctAleSolver(mesh, cfg, backend="torch", device="cpu")
    for call in (lambda: solver.step_tracers(s),
                 lambda: solver.run_tracers(s, 2)):
        with pytest.raises(ValueError, match="backend='cuda'"):
            call()
    with pytest.raises(ValueError, match="cuda-only"):
        ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2, tracers=2)
    # hnode and hnode_new are shared [L, N], never per tracer
    bad = dict(s, hnode=torch.stack([s["hnode"]] * TB))
    with pytest.raises(ValueError, match="hnode has shape"):
        fct_ale_step_cuda_batched(md, cfg, bad)
    with pytest.raises(ValueError, match="hnode has shape"):
        fct_ale_step_cuda_batched(md, cfg, bad, fuse_k34=False)
    # a tracer axis needs a tracer, and the same Tb on every input
    with pytest.raises(ValueError, match="at least one tracer"):
        kernels.bounds(md, s["fct_LO"][:0], s["ttf"][:0], 1)
    with pytest.raises(ValueError, match="ttf has shape"):
        kernels.bounds(md, s["fct_LO"], s["ttf"][:2], 1)
    assert sum(kernels.launch_counts().values()) == 0
    assert build.library.cache_info().currsize == 0


# --------------------------------------------------------------------------
# (g) kernel_io with tracers
# --------------------------------------------------------------------------

# profiling.kernel_io on the small mesh, float32, before the tracer axis
# (bytes, operations), ids = every third edge
SMALL_IO = {
    (False, "bounds"): (145168, 231152), (True, "bounds"): (145168, 231152),
    (False, "limit"): (323050, 312560), (True, "limit"): (359914, 312560),
    (False, "limit_fused"): (402290, 543712),
    (True, "limit_fused"): (439154, 543712),
    (False, "update_fused"): (588338, 530640),
    (True, "update_fused"): (534990, 530640),
    (False, "update"): (402922, 156280), (True, "update"): (250858, 156280),
    (False, "b3h"): (264580, 149744), (True, "b3h"): (363296, 149744),
    (False, "b3h_fixup"): (123512, 49984),
    (True, "b3h_fixup"): (156448, 49984),
    (False, "a2"): (192272, 47832), (True, "a2"): (192272, 47832),
}


@pytest.mark.parametrize("iter_yn", [False, True])
def test_kernel_io_counts_shared_bytes_once(iter_yn):
    mesh = generate_planar_mesh(preset="small")
    md = build_mesh_data(mesh, torch.float32, "cpu")
    ids = torch.arange(0, md.n_edges, 3, dtype=torch.int32)
    N, Ed, f = md.n_nodes, md.n_edges, 4
    n_live, nod = int(md.nd_num.sum()), int(md.node_mask.sum())
    stage_c = (2 if iter_yn else 3) * nod * f  # hnode(_new), area_inv
    shared = {  # connectivity and rows, area_inv, hnode, hnode_new, ids
        "bounds": 8 * n_live + 8 * N,
        "limit": nod * f + 9 * n_live + 8 * N,
        "update_fused": stage_c + 13 * n_live + 8 * N,
        "update": stage_c + 9 * n_live + 8 * N,
        "limit_fused": nod * f + 13 * n_live + 8 * N,
        "b3h": 12 * Ed,
        "b3h_fixup": 4 * len(ids) + 12 * len(ids),
    }
    for (it, name), want in SMALL_IO.items():
        if it != iter_yn:
            continue
        assert profiling.kernel_io(md, name, iter_yn, ids=ids) == want
        if name not in shared:
            with pytest.raises(ValueError, match="tracers"):
                profiling.kernel_io(md, name, iter_yn, tracers=2)
            continue
        io = {tb: profiling.kernel_io(md, name, iter_yn, ids=ids,
                                      tracers=tb) for tb in (1, 2, 8)}
        per = io[2][0] - io[1][0]
        assert io[1][0] - per == shared[name], name
        assert io[8][0] == shared[name] + 8 * per, name
        assert io[8][1] == 8 * io[1][1], name
