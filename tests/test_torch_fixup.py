"""PyTorch port: K4-fix (``kernels.update_fixup``), H-K4's FIX form, which
does K3fix's work in K4's launch on a part of a sharded split step.

On CPU tensors the wrapper runs its plain version, ``update_fixup_ref``:
b3 horizontal again on the part's halo edges (``kernels.fixup_edges``),
in place into K3's outputs, then K4's plain version.  Held here:

* on every part of small at 4 and 8 parts, the multi-hop mesh at 8 parts
  and the RCM cylinder at 4 RCB parts, after a real halo exchange, the
  fold equals the two-launch witness ``b3h_fixup_ref(fix_edge_ids) ->
  update_ref`` bit for bit, f32 and f64, ``iter_yn`` both ways, at Tb = 1
  and 3 (each tracer of Tb = 3 also equal to its Tb = 1 call);
* the edges it limits again are exactly ``fix_edge_ids`` on every part;
* the owned-columns contract and a block size other than FIX_THREADS are
  refused, and off the CPU the wrapper refuses any device but CUDA before
  a launch;
* a split step at 4 parts calls K1, K2, K3 and K4-fix once a part, and
  neither K3fix nor the plain K4, at Tb = 1 and 2;
* ``profiling.kernel_io("update_fixup")`` against a hand count.

The split-mode tests of tests/test_torch_sharded.py and
tests/test_torch_tracers.py hold the step that runs the fold against the
JAX package's split chain (Pallas, interpret mode) and the single-device
step."""

import functools

import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu_torch import FctAleConfig, ShardedFctAleSolver
from fesom2_accelerate_tpu_torch.mesh import (
    generate_cylinder_mesh,
    generate_planar_mesh,
    ordering,
    random_fields,
)
from fesom2_accelerate_tpu_torch.ops.cuda import build, kernels
from fesom2_accelerate_tpu_torch.ops.cuda.step import (
    BATCH_SHARED,
    pre_exchange,
)
from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data
from fesom2_accelerate_tpu_torch.parallel.step_sharded import (
    fix_edge_ids,
    sharded_fct_ale_step_cuda,
)
from fesom2_accelerate_tpu_torch.runtime import profiling

DT = 0.7
EPS = {torch.float32: 1e-7, torch.float64: 1e-16}


def _rcb(mesh, n_parts):
    perm, counts = ordering.rcb_order(mesh, n_parts)
    return ordering.reorder_mesh(mesh, perm)[0], counts


# (mesh and RCB counts or None, parts), as tests/test_torch_partition.py
CASES = {
    "small-4": (lambda: (generate_planar_mesh(preset="small"), None), 4),
    "small-8": (lambda: (generate_planar_mesh(preset="small"), None), 8),
    "multihop-8": (lambda: (generate_planar_mesh(nx=4, ny=7, nl=5), None),
                   8),
    "cylinder-rcb-4": (lambda: _rcb(generate_cylinder_mesh(20, 12, 6)[0], 4),
                       4),
}


@functools.cache
def _solver(case: str, dtype: torch.dtype) -> ShardedFctAleSolver:
    make, n_parts = CASES[case]
    mesh, counts = make()
    sh = ShardedFctAleSolver(mesh, FctAleConfig(dtype=dtype),
                             devices=["cpu"] * n_parts, part_counts=counts)
    if case == "multihop-8":
        assert sh.pm.neighbor_radius >= 2
    return sh


def _fields(mesh, tb: int) -> dict:
    """One tracer's fields (tb = 1) or tb tracers' stacked, ``hnode`` and
    ``hnode_new`` shared, from random_fields(seed=5 + t)."""
    per = [random_fields(mesh, seed=5 + t) for t in range(tb)]
    if tb == 1:
        return per[0]
    return {k: per[0][k] if k in BATCH_SHARED
            else np.stack([f[k] for f in per]) for k in per[0]}


def _exchanged(sh, cfg, tb: int) -> tuple:
    """Per-part (state, K1/K2 outputs with exchanged factors, K3's outputs
    on the pre-exchange factors), as a split step has them when K4-fix
    runs."""
    sh.tracers = tb  # state movement is the CUDA backend's (its solver
    # needs a card); the plain versions take the tracer axis
    try:
        state = sh.init_state(_fields(sh.mesh, tb))
    finally:
        sh.tracers = 1
    parts = [{k: v[p] for k, v in state.items()} for p in range(sh.n_parts)]
    pres = [pre_exchange(md, cfg, s) for md, s in zip(sh.mds, parts)]
    edges = [kernels.b3h(md, pre["fct_plus"], pre["fct_minus"],
                         s["fct_adf_h"], cfg.iter_yn)
             for md, s, pre in zip(sh.mds, parts, pres)]
    sh.halo_fill([pre["fct_plus"] for pre in pres])
    sh.halo_fill([pre["fct_minus"] for pre in pres])
    return parts, pres, edges


def _fold(md, s, pre, edges, owned, iter_yn):
    lim, res = edges
    return kernels.update_fixup(
        md, pre["fct_plus"], pre["fct_minus"], s["fct_adf_h"], lim.clone(),
        res.clone() if iter_yn else None, owned, pre["adf_v_lim"], s["ttf"],
        s["hnode"], s["hnode_new"], s["fct_LO"], s["del_ttf_advvert"],
        s["del_ttf_advhoriz"], DT, iter_yn)


def _witness(md, s, pre, edges, ids, iter_yn):
    """K3fix -> K4, plain: the two launches the fold replaces."""
    lim, res = kernels.b3h_fixup_ref(
        md, pre["fct_plus"], pre["fct_minus"], s["fct_adf_h"],
        edges[0].clone(), edges[1].clone() if iter_yn else None, ids,
        iter_yn)
    o1, o2 = kernels.update_ref(
        md, pre["adf_v_lim"], lim, s["ttf"], s["hnode"], s["hnode_new"],
        s["fct_LO"], s["del_ttf_advvert"], s["del_ttf_advhoriz"], DT,
        iter_yn)
    return o1, o2, lim, res


def _assert_same(got, want, msg):
    """Bit for bit, output by output (np.testing treats the 0/0 of a
    part's empty pad columns in iterative stage c as equal)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, f"{msg} out{i}"
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, f"{msg} out{i}"
        np.testing.assert_array_equal(g.numpy(), w.numpy(),
                                      err_msg=f"{msg} out{i}")


@pytest.mark.parametrize("tb", [1, 3])
@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_is_fixup_then_update(case, dtype, iter_yn, tb):
    sh = _solver(case, dtype)
    cfg = FctAleConfig(dt=DT, iter_yn=iter_yn, flux_eps=EPS[dtype],
                       dtype=dtype)
    owned = (sh.pm.H, sh.pm.H + sh.pm.B)
    kernels.reset_launch_counts()
    for p, (md, s, pre, e) in enumerate(zip(sh.mds, *_exchanged(sh, cfg,
                                                                 tb))):
        ids = torch.from_numpy(fix_edge_ids(sh.pm, p))
        got = _fold(md, s, pre, e, owned, iter_yn)
        _assert_same(got, _witness(md, s, pre, e, ids, iter_yn),
                     f"{case} part {p}")
        # the fold changed K3's values at its edges only
        changed = ~torch.eq(got[2], e[0]).reshape(-1, md.n_edges).all(0)
        assert set(torch.nonzero(changed).flatten().tolist()) <= \
            set(ids.tolist())
        if tb == 1:
            continue
        for t in range(tb):
            one = {k: v if k in BATCH_SHARED else v[t] for k, v in s.items()}
            pre_t = {k: None if v is None else v[t] for k, v in pre.items()}
            want = _fold(md, one, pre_t, tuple(
                None if x is None else x[t] for x in e), owned, iter_yn)
            _assert_same(tuple(None if g is None else g[t] for g in got),
                         want, f"{case} part {p} tracer {t}")
    assert not any(kernels.launch_counts().values())
    assert build.library.cache_info().currsize == 0, \
        "the CPU path must not build or load the CUDA library"


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_relimits_exactly_the_fix_edges(case):
    """On every part, the edges K4-fix limits again are fix_edge_ids: by
    the rows it reads (fixup_edges), and by what the plain version writes
    into a sentinel array, every level of those edges and nothing else."""
    sh = _solver(case, torch.float64)
    owned = (sh.pm.H, sh.pm.H + sh.pm.B)
    cfg = FctAleConfig(dt=DT, dtype=torch.float64)
    parts, pres, edges = _exchanged(sh, cfg, 1)
    for p, (md, s, pre) in enumerate(zip(sh.mds, parts, pres)):
        ids = fix_edge_ids(sh.pm, p)
        got = kernels.fixup_edges(md, owned)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ids)
        assert len(ids) > 0
        sentinel = torch.full_like(edges[p][0], -7.0)
        lim = _fold(md, s, pre, (sentinel, None), owned, False)[2]
        written = (lim != -7.0).all(0)
        assert not (lim[:, ~written] != -7.0).any()
        np.testing.assert_array_equal(
            torch.nonzero(written).flatten().numpy(), ids)


def test_fold_refuses_a_broken_contract():
    """The owned columns must hold every node with an incidence row (so an
    edge with an endpoint outside has one row) and lie within the mesh;
    on a whole mesh only the full range holds them, and the fold is then
    K4 itself."""
    sh = _solver("small-4", torch.float64)
    H, B = sh.pm.H, sh.pm.B
    cfg = FctAleConfig(dt=DT, dtype=torch.float64)
    parts, pres, edges = _exchanged(sh, cfg, 1)
    md, s, pre, e = sh.mds[1], parts[1], pres[1], edges[1]
    assert md.row_span[0] >= H and md.row_span[1] <= H + B
    for owned in ((H + 1, H + B), (H, H + B - 1), (H + B, H),
                  (-1, md.n_nodes), (0, md.n_nodes + 1)):
        with pytest.raises(ValueError, match="owned"):
            _fold(md, s, pre, e, owned, False)
    _fold(md, s, pre, e, (0, md.n_nodes), False)  # a wider range is fine
    with pytest.raises(ValueError, match="threads"):
        kernels.update_fixup(md, pre["fct_plus"], pre["fct_minus"],
                             s["fct_adf_h"], e[0].clone(), None, (H, H + B),
                             pre["adf_v_lim"], s["ttf"], s["hnode"],
                             s["hnode_new"], s["fct_LO"],
                             s["del_ttf_advvert"], s["del_ttf_advhoriz"], DT,
                             False, threads=256)

    mesh = generate_planar_mesh(preset="small")
    whole = build_mesh_data(mesh, torch.float64, "cpu")
    assert whole.row_span == (0, mesh.n_nodes)
    s = {k: torch.from_numpy(v) for k, v in random_fields(mesh).items()}
    pre = pre_exchange(whole, cfg, s)
    e = kernels.b3h(whole, pre["fct_plus"], pre["fct_minus"], s["fct_adf_h"],
                    False)
    with pytest.raises(ValueError, match="owned"):
        _fold(whole, s, pre, e, (1, mesh.n_nodes), False)
    assert kernels.fixup_edges(whole, (0, mesh.n_nodes)).numel() == 0
    got = _fold(whole, s, pre, e, (0, mesh.n_nodes), False)
    _assert_same(got, _witness(whole, s, pre, e, torch.zeros(
        0, dtype=torch.int32), False), "whole mesh")

    meta = build_mesh_data(mesh, torch.float32, "meta")
    L, N, Ed = meta.n_layers, meta.n_nodes, meta.n_edges
    node = torch.empty((L, N), device="meta")
    edge = torch.empty((L, Ed), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.update_fixup(meta, node, node, edge, edge, None, (0, N),
                             torch.empty((L + 1, N), device="meta"), node,
                             node, node, node, node, node, DT, False)


def _counting(monkeypatch) -> dict:
    """Replace each kernel wrapper by one that counts its calls (then runs
    it): on the CPU no wrapper launches, but the calls are the launches
    the same step makes on a card."""
    calls = {}
    for w in kernels.WRAPPERS:
        name = w.__name__
        calls[name] = 0

        def shim(*a, _w=w, _n=name, **kw):
            calls[_n] += 1
            return _w(*a, **kw)
        monkeypatch.setattr(kernels, name, shim)
    return calls


@pytest.mark.parametrize("tb", [1, 2])
def test_split_step_calls_four_kernels_a_part(monkeypatch, tb):
    """A sharded split step at 4 parts: K1, K2, K3 and K4-fix once a part
    (16 launches on a card, at any Tb), no K3fix and no plain K4; it
    equals the witness chain's step."""
    sh = _solver("small-4", torch.float32)
    sh.tracers = tb
    try:
        state = sh.init_state(_fields(sh.mesh, tb))
    finally:
        sh.tracers = 1
    cfg = FctAleConfig(dt=DT, flux_eps=EPS[torch.float32])
    parts = [{k: v[p] for k, v in state.items()} for p in range(4)]
    calls = _counting(monkeypatch)
    outs = sharded_fct_ale_step_cuda(sh.mds, cfg, sh.halo_fill, parts,
                                     (sh.pm.H, sh.pm.H + sh.pm.B))
    assert calls == dict({n: 0 for n in calls}, bounds=4, limit=4, b3h=4,
                         update_fixup=4)
    monkeypatch.undo()
    # the step's outputs are the witness chain's on the same inputs
    _, pres, edges = _exchanged(sh, cfg, tb)
    for p, (md, s) in enumerate(zip(sh.mds, parts)):
        ids = torch.from_numpy(fix_edge_ids(sh.pm, p))
        o1, o2, lim, _ = _witness(md, s, pres[p], edges[p], ids, False)
        for k, v in (("del_ttf_advvert", o1), ("del_ttf_advhoriz", o2),
                     ("fct_adf_h", lim)):
            np.testing.assert_array_equal(outs[p][k].numpy(), v.numpy(),
                                          err_msg=f"{k} part {p}")


def _gathered_by_hand(md, ids) -> int:
    """Node-levels of the fix edges' endpoints, each node once, to the
    deepest of its fix edges."""
    depth = np.zeros(md.n_nodes, np.int64)
    edges, nlev = md.edges.numpy(), md.nlev_edge.numpy()
    for e in ids:
        for n in edges[e]:
            depth[n] = max(depth[n], nlev[e])
    return int(depth.sum())


@pytest.mark.parametrize("iter_yn", [False, True])
def test_kernel_io_update_fixup_hand_count(iter_yn):
    """K4's bytes and operations, plus: the other endpoints on every live
    slot (shared), the raw flux of each fix edge in place of its limited
    flux (the same count), both factors of both endpoints on the fix
    edges' levels, and the limited flux (and residual) written there; 8
    operations a fix edge-level.  Tracers scale what is not shared."""
    sh = _solver("small-4", torch.float32)
    owned = (sh.pm.H, sh.pm.H + sh.pm.B)
    md = sh.mds[1]
    ids = fix_edge_ids(sh.pm, 1)
    f = 4
    n_live = int(md.nd_num.sum())
    fix_act = int(md.nlev_edge.numpy()[ids].sum())
    gath = _gathered_by_hand(md, ids)
    assert fix_act > 0 and gath > 0
    k4_bytes, k4_ops = profiling.kernel_io(md, "update", iter_yn)
    extra = 2 * gath * f + (2 if iter_yn else 1) * fix_act * f
    assert profiling.kernel_io(md, "update_fixup", iter_yn, owned=owned) == (
        k4_bytes + 4 * n_live + extra, k4_ops + 8 * fix_act)
    k4_2 = profiling.kernel_io(md, "update", iter_yn, tracers=2)[0]
    fx_2 = profiling.kernel_io(md, "update_fixup", iter_yn, owned=owned,
                               tracers=2)
    assert fx_2 == (k4_2 + 4 * n_live + 2 * extra, 2 * (k4_ops + 8 * fix_act))
    with pytest.raises(ValueError, match="owned"):
        profiling.kernel_io(md, "update_fixup", iter_yn)


def test_sass_pairs_each_instance_with_its_flags_off():
    """utils/sass.py (the check that H-K4's plain instances keep their
    code) reads the kernel and template arguments from cuobjdump's
    function lines and pairs an instance of the other build with the one
    here whose extra flags are all off, never with a FIX instance."""
    from fesom2_accelerate_tpu_torch.utils import sass

    line = ("\t\tFunction : _ZN36_GLOBAL__N__f6935f_10_fct_ale_cu_7df9e150"
            "13update_kernelIfLi8ELi128ELb0ELb1EEEvPKT_S3_")
    assert sass._NAME.search(line).groups() == ("update_kernel",
                                                "fLi8ELi128ELb0ELb1E")
    line = "Function : _ZN36_GLOBAL__N__f_10_fct_ale_cu_7d9a2_kernelIdLi64EEEv"
    assert sass._NAME.search(line).groups() == ("a2_kernel", "dLi64E")
    old = {("update_kernel", "fLi8ELi128ELb0E"): ["A"],
           ("update_kernel", "fLi8ELi128ELb1E"): ["B"],
           ("update_fused_kernel", "fLi8ELi128ELb0E"): ["C"]}
    new = {("update_kernel", "fLi8ELi128ELb0ELb0E"): ["A"],
           ("update_kernel", "fLi8ELi128ELb0ELb1E"): ["A"],
           ("update_kernel", "fLi8ELi128ELb1ELb0E"): ["B2"],
           ("update_kernel", "fLi8ELi128ELb1ELb1E"): ["B"]}
    assert sass.compare(old, new) == [
        "MISSING update_fused_kernel<fLi8ELi128ELb0E>: 0 counterparts",
        "same update_kernel<fLi8ELi128ELb0E> as <fLi8ELi128ELb0ELb0E>: 1 "
        "lines",
        "DIFFERENT update_kernel<fLi8ELi128ELb1E> as <fLi8ELi128ELb1ELb0E>: "
        "1 lines"]
