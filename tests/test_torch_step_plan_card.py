"""PyTorch port: the whole step enqueued from a launch plan
(``ops/cuda/step.py`` ``StepPlans``), on the card.

Marked ``card``: each test skips where there is no CUDA device.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
neither, without the suite's ``conftest.py``::

    python -m pytest --noconftest tests/test_torch_step_plan_card.py

* ``run_tracers(state, 1)`` at Tb = 1 and 2 and ``run(state, 1)`` of one
  tracer, ``iter_yn`` both ways, give the bits of ``kernels.bounds`` ->
  ``limit`` -> ``update_fused`` called directly on the same state, with
  one launch of each a step; the other three forms against their
  wrappers' chain (``fct_ale_step_cuda`` of the wrappers);
* a 30-step ``StepGraphs`` replay, captured through the plan, equals the
  loop of 30 steps bit for bit, with the loop's launch counts;
* one plan a signature (``solver.plans_built``), every step from it
  (``solver.plan_steps``); a state on the CPU raises the wrappers' error;
* under ``torch.profiler`` each step holds the spans ``kernels.bounds``,
  ``kernels.limit`` and ``kernels.update_fused`` under ``solver.step``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import (
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.model import FctAleSolver
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.cuda import step as cstep
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
    """K1 -> K2 -> K34 through their wrappers: the output dict."""
    md, cfg = solver.md, solver.cfg
    tmax, tmin = kernels.bounds(md, state["fct_LO"], state["ttf"],
                                cfg.vlimit)
    plus, minus, v_lim, v_res = kernels.limit(
        md, state["fct_adf_v"], tmax, tmin, state["fct_adf_h"], cfg.dt,
        cfg.flux_eps, cfg.iter_yn)
    o1, o2, h_lim, h_res = kernels.update_fused(
        md, plus, minus, v_lim, state["fct_adf_h"], state["ttf"],
        state["hnode"], state["hnode_new"], state["fct_LO"],
        state["del_ttf_advvert"], state["del_ttf_advhoriz"], cfg.dt,
        cfg.iter_yn)
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
    assert (c["bounds"], c["limit"], c["update_fused"],
            sum(c.values())) == (2, 2, 2, 6)
    assert tracing.counters() == {"solver.plans_built": 1,
                                  "solver.plan_steps": 2}


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("fuse_k12,fuse_k34",
                         [(False, False), (True, True), (True, False)])
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
    assert per_loop["bounds"] == per_loop["update_fused"] == 30
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
        "kernels.bounds", "kernels.limit", "kernels.update_fused"] * 3
    for s in kernel_spans:
        assert spans[s.parent].name == "solver.step"
        assert s.end_ns is not None and s.start_ns <= s.end_ns
