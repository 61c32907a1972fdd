"""PyTorch port: the whole step enqueued from a launch plan
(``ops/cuda/step.py`` ``StepPlans``), on the card.

Marked ``card``: each test skips where there is no CUDA device.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
neither, without the suite's ``conftest.py``::

    python -m pytest --noconftest tests/test_torch_step_plan_card.py

* ``run_tracers(state, 1)`` at Tb = 1 and 2 and ``run(state, 1)`` of one
  tracer, ``iter_yn`` both ways, give the bits of ``kernels.limit_fused``
  -> ``b3h`` -> ``update`` (the default form) called directly on the same
  state, with one launch of each a step; the other three forms against
  their wrappers' chain (``fct_ale_step_cuda`` of the wrappers);
* on core2, in float32 and float64 at Tb = 2, the default step gives the
  bits of the explicit ``fuse_k12=False, fuse_k34=True`` step (K1 -> K2
  -> K34), and counts every step in ``solver.k12_steps``;
* H-K12 with the tracer axis: at Tb = 2 and 3 each tracer's outputs are
  the bits of a Tb = 1 launch on its slice and of H-K1 -> H-K2 at the
  same Tb, vlimit 1/2/3 x ``iter_yn`` in float32 and float64, on core2 and
  on planar meshes whose layer counts straddle its level chunk (L = 2,
  23, 24, 25, 49);
* no kernel instance spills (``build.ptxas_report`` of the build's log),
  H-K12's instances with and without the tracer axis among them;
* a 30-step ``StepGraphs`` replay, captured through the plan, equals the
  loop of 30 steps bit for bit, with the loop's launch counts;
* one plan a signature (``solver.plans_built``), every step from it
  (``solver.plan_steps``); a state on the CPU raises the wrappers' error;
* under ``torch.profiler`` each step holds the spans
  ``kernels.limit_fused``, ``kernels.b3h`` and ``kernels.update`` under
  ``solver.step``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import (
    build_mesh_from_elements,
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.model import FctAleSolver
from fesom2_accelerate_tpu_torch.ops.cuda import build, kernels
from fesom2_accelerate_tpu_torch.ops.cuda import step as cstep
from fesom2_accelerate_tpu_torch.ops.meshdata import (
    LIMIT_FUSED_LEVELS,
    build_mesh_data,
)
from fesom2_accelerate_tpu_torch.runtime import graphs, tracing

pytestmark = pytest.mark.card

_INT = {torch.float32: torch.int32, torch.float64: torch.int64}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.cuda.get_device_name(0)


@pytest.fixture(scope="module")
def small(card):
    return generate_planar_mesh(preset="small")


@pytest.fixture(scope="module")
def core2(card):
    return generate_planar_mesh(preset="core2")


@pytest.fixture(autouse=True)
def counts():
    kernels.reset_launch_counts()
    tracing.reset_counters()
    yield
    kernels.reset_launch_counts()
    tracing.reset_counters()


def _fields(mesh, tb, seed=11):
    """One tracer's fields (``tb`` None) or ``tb`` tracers'."""
    f = random_fields(mesh, seed=seed)
    if tb is None:
        return f
    return {k: v if k in cstep.BATCH_SHARED
            else np.stack([v * (1 + 0.5 * t) for t in range(tb)])
            for k, v in f.items()}


def _same_bits(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(_INT[a.dtype]), b.view(_INT[b.dtype])))


def _direct(solver, state):
    """K12 -> K3 -> K4 through their wrappers: the output dict."""
    md, cfg = solver.md, solver.cfg
    tmax, tmin, plus, minus, v_lim, v_res = kernels.limit_fused(
        md, state["fct_LO"], state["ttf"], state["fct_adf_v"],
        state["fct_adf_h"], cfg.vlimit, cfg.dt, cfg.flux_eps, cfg.iter_yn)
    h_lim, h_res = kernels.b3h(md, plus, minus, state["fct_adf_h"],
                               cfg.iter_yn)
    o1, o2 = kernels.update(
        md, v_lim, h_lim, state["ttf"], state["hnode"], state["hnode_new"],
        state["fct_LO"], state["del_ttf_advvert"],
        state["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn)
    pre = dict(fct_ttf_max=tmax, fct_ttf_min=tmin, fct_plus=plus,
               fct_minus=minus, adf_v_lim=v_lim, adf_v_res=v_res)
    return cstep._assemble(cfg, state, pre, o1, o2, h_lim, h_res)


def _solver(mesh, iter_yn, dtype=torch.float32, **form):
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, iter_yn=iter_yn, dtype=dtype)
    return FctAleSolver(mesh, cfg, device="cuda", **form)


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("tb", [None, 1, 2])
def test_a_planned_step_is_the_wrappers_bits(small, tb, iter_yn):
    solver = _solver(small, iter_yn)
    state = solver.init_state(_fields(small, tb))
    want = _direct(solver, state)
    kernels.reset_launch_counts()
    run = solver.run if tb is None else solver.run_tracers
    step = solver.step if tb is None else solver.step_tracers
    got = run(state, 1)
    one = step(state)
    torch.cuda.synchronize()
    assert got.keys() == state.keys()
    for k in state:
        assert _same_bits(got[k], want[k]), k
    for k, v in want.items():
        assert _same_bits(one[k], v), k
    c = kernels.launch_counts()
    assert (c["limit_fused"], c["b3h"], c["update"],
            sum(c.values())) == (2, 2, 2, 6)
    assert tracing.counters() == {"solver.plans_built": 1,
                                  "solver.plan_steps": 2,
                                  "solver.k12_steps": 2}


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("fuse_k12,fuse_k34",
                         [(False, True), (False, False), (True, True)])
def test_the_other_forms_are_their_wrappers_bits(small, fuse_k12, fuse_k34,
                                                 iter_yn):
    solver = _solver(small, iter_yn, fuse_k12=fuse_k12, fuse_k34=fuse_k34)
    state = solver.init_state(_fields(small, None))
    want = cstep.fct_ale_step_cuda(solver.md, solver.cfg, state,
                                   fuse_k12=fuse_k12, fuse_k34=fuse_k34)
    wrappers = kernels.launch_counts()
    kernels.reset_launch_counts()
    got = solver.step(state)
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert _same_bits(got[k], v), k
    assert kernels.launch_counts() == wrappers
    assert tracing.counters()["solver.plans_built"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_graph_replay_through_the_plan_is_the_loop(small, dtype):
    solver = _solver(small, False, dtype)
    state = solver.init_state_tracers(_fields(small, 2))
    loop = graphs.loop(solver.step_tracers, state, 30)
    torch.cuda.synchronize()
    per_loop = kernels.launch_counts()
    kernels.reset_launch_counts()
    replayed = solver._graphs.replay(solver.step_tracers, state, 30)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == per_loop
    assert per_loop["limit_fused"] == per_loop["update"] == 30
    assert replayed.keys() == state.keys()
    for k in state:
        assert _same_bits(replayed[k], loop[k]), k
    assert tracing.counters()["solver.plans_built"] == 1


def test_a_state_off_the_card_raises_the_wrappers_error(small):
    solver = _solver(small, False)
    state = solver.init_state(_fields(small, 2))
    solver.run_tracers(state, 1)
    state["hnode"] = state["hnode"].cpu()
    with pytest.raises(ValueError, match="hnode is on cpu, mesh data on "
                                         "cuda:0"):
        solver.run_tracers(state, 1)
    state["fct_LO"] = state["fct_LO"].cpu()
    with pytest.raises(ValueError, match="fct_LO is on cpu"):
        solver.run_tracers(state, 1)
    with pytest.raises(ValueError, match="n_steps must be >= 0"):
        solver.run_tracers(solver.init_state(_fields(small, 2)), -1)


def test_the_kernel_spans_under_a_profiler(small):
    solver = _solver(small, False)
    state = solver.init_state_tracers(_fields(small, 2))
    solver.run_tracers(state, 1)
    torch.cuda.synchronize()
    tracing.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            solver.run_tracers(state, 1)
        torch.cuda.synchronize()
    spans = tracing.spans()
    tracing.reset_spans()
    kernel_spans = [s for s in spans if s.name.startswith("kernels.")]
    assert [s.name for s in kernel_spans] == [
        "kernels.limit_fused", "kernels.b3h", "kernels.update"] * 3
    for s in kernel_spans:
        assert spans[s.parent].name == "solver.step"
        assert s.end_ns is not None and s.start_ns <= s.end_ns


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_default_step_is_the_k1_k2_k34_steps_bits(core2, dtype):
    """The whole-mesh default, K12 -> K3 -> K4, against the explicit K1 ->
    K2 -> K34 on core2 at Tb = 2: every output bit for bit (K12 gives the
    bits of K1 -> K2, K3 -> K4 those of K34), over 3 steps."""
    chosen = _solver(core2, False, dtype)
    explicit = _solver(core2, False, dtype, fuse_k12=False, fuse_k34=True)
    state = chosen.init_state_tracers(_fields(core2, 2))
    got, want = state, state
    for _ in range(3):
        got = chosen.step_tracers(got)
        want = explicit.step_tracers(want)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert _same_bits(got[k], v), k
        got = {k: got[k] for k in state}
        want = {k: want[k] for k in state}
    torch.cuda.synchronize()
    c = kernels.launch_counts()
    assert (c["limit_fused"], c["b3h"], c["update"]) == (3, 3, 3)
    assert (c["bounds"], c["limit"], c["update_fused"]) == (3, 3, 3)
    n = tracing.counters()
    assert n["solver.k12_steps"] == 3 and n["solver.plan_steps"] == 6


def _chunk_meshes(small):
    """Planar meshes of small's 24 x 16 nodes whose layer counts straddle
    H-K12's level chunk: L = 2, LC - 1, LC, LC + 1 and 2 LC + 1 (L = 2 from
    small's elements, every one 3 levels deep: below what the generator
    takes)."""
    lc = LIMIT_FUSED_LEVELS
    out = {}
    for n_layers in (2, lc - 1, lc, lc + 1, 2 * lc + 1):
        nl = n_layers + 1
        out[f"L={n_layers}"] = (
            generate_planar_mesh(nx=24, ny=16, nl=nl) if nl >= 4 else
            build_mesh_from_elements(small.elem_nodes,
                                     np.full(small.n_elems, nl), nl,
                                     small.node_xy))
    return out


K12_CASES = [(dtype, v, it) for dtype in (torch.float32, torch.float64)
             for v in (1, 2, 3) for it in (False, True)]


@pytest.mark.parametrize("key", ["core2", "L=2", "L=23", "L=24", "L=25",
                                 "L=49"])
def test_k12_at_several_tracers_is_its_single_launches(small, core2, key):
    """H-K12 at Tb = 2 and 3: each tracer's outputs are the bits of a
    Tb = 1 launch on its slice and of H-K1 -> H-K2 at the same Tb."""
    mesh = core2 if key == "core2" else _chunk_meshes(small)[key]
    fields = _fields(mesh, 3)
    mds = {dt: build_mesh_data(mesh, dt, "cuda")
           for dt in (torch.float32, torch.float64)}
    for dtype, vlimit, iter_yn in K12_CASES:
        md = mds[dtype]
        eps = 1e-7 if dtype == torch.float32 else 1e-16
        every = {k: torch.tensor(v, dtype=dtype, device="cuda")
                 for k, v in fields.items()}
        for tb in (2, 3):
            s = {k: v if k in cstep.BATCH_SHARED else v[:tb].contiguous()
                 for k, v in every.items()}
            args = (s["fct_LO"], s["ttf"], s["fct_adf_v"], s["fct_adf_h"])
            got = kernels.limit_fused(md, *args, vlimit, 0.5, eps, iter_yn)
            chain = kernels.bounds(md, s["fct_LO"], s["ttf"], vlimit)
            chain += kernels.limit(md, s["fct_adf_v"], *chain,
                                   s["fct_adf_h"], 0.5, eps, iter_yn)
            case = f"{key} {dtype} vlimit={vlimit} iter={iter_yn} Tb={tb}"
            for i, (g, c) in enumerate(zip(got, chain)):
                assert _same_bits(g, c), f"{case}: output {i} vs K1 -> K2"
            for t in range(tb):
                one = kernels.limit_fused(
                    md, *(a[t].contiguous() for a in args), vlimit, 0.5,
                    eps, iter_yn)
                for i, (g, o) in enumerate(zip(got, one)):
                    assert _same_bits(None if g is None else g[t], o), \
                        f"{case}: output {i} of tracer {t}"
    torch.cuda.synchronize()


def test_no_kernel_instance_spills(card):
    """Every instance in the build's ptxas report spills nothing; H-K12
    has its instances with and without the tracer axis in both dtypes."""
    build.library()
    report = []
    for source in build.SOURCES:
        log = build.library_path(source).with_suffix(".log").read_text()
        report += build.ptxas_report(log)
    assert report
    spills = [r for r in report
              if r.get("spill_stores") or r.get("spill_loads")]
    assert spills == []
    k12 = {(r["dtype"], r["tracers"]) for r in report
           if r["kernel"] == "limit_fused_kernel"}
    assert k12 == {(d, t) for d in ("float", "double")
                   for t in (False, True)}
    for r in report:
        if r["kernel"] == "limit_fused_kernel":
            print(f"limit_fused<{r['dtype']},{r['params']},"
                  f"tracers={r['tracers']}>: {r['registers']} registers")
