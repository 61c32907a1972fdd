"""PyTorch port: the whole step enqueued from a launch plan
(``ops/cuda/step.py`` ``StepPlan``, ``StepPlans``).

The plan launches CUDA kernels, so ``tests/test_torch_step_plan_card.py``
holds its bits against the wrappers on the card.  Here, on the CPU, with
launchers that record their arguments in place of the kernel library
(``build.library``) and no stream or device guard:

* ``check_state`` raises the kernel wrappers' errors for a state field of
  another shape, dtype or device, or one that is not contiguous, and a
  plan's ``fits`` refuses each of them;
* every form of the step, ``iter_yn`` both ways, with and without a
  tracer axis: the plan launches the kernels of the wrappers' chain
  (``fct_ale_step_cuda`` with the launches let through) in the same order
  with the same arguments, state, mesh data and outputs alike, adds the
  same launch counts, and returns outputs of the same keys, shapes and
  dtypes;
* a plan is built once per signature and reused (``solver.plans_built``,
  ``solver.plan_steps``); a changed Tb, shape or dtype builds a new one;
* a field the first kernel does not read, refused after that kernel's
  launch, raises the wrapper's error and launches nothing more;
* mesh data on the CPU runs the wrappers' plain versions, from no plan;
* where the caller names no form, the plan launches K12 -> K3 -> K4 on
  every mesh the tier-1 tests build, at one tracer and at several, and
  counts each such step in ``solver.k12_steps`` as in
  ``solver.plan_steps``; an explicit flag chooses its form, and the
  solver hands its flags to both of its step functions;
* a run of 0 or 1 steps calls the step that many times and computes no
  signature key (``graphs.StepGraphs.run``).
"""

import contextlib
import ctypes
import functools

import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import (
    generate_cylinder_mesh,
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.model import FctAleSolver
from fesom2_accelerate_tpu_torch.model import fct_ale as fct_ale_model
from fesom2_accelerate_tpu_torch.ops.cuda import build, kernels
from fesom2_accelerate_tpu_torch.ops.cuda import step as cstep
from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data
from fesom2_accelerate_tpu_torch.runtime import graphs, tracing

TB = 2
# the stream handle the recording launchers are given
STREAM = 77


def _value(a):
    return a.value if isinstance(a, ctypes._SimpleCData) else a


class Launches:
    """Launchers of every kernel that record (name, arguments) and report
    success, in place of ``build.library()``."""

    def __init__(self):
        self.calls = []
        for name in build.ARGTYPES:
            for suffix in ("_f32", "_f64"):
                setattr(self, name + suffix,
                        functools.partial(self._record, name + suffix))

    def _record(self, name, *args):
        self.calls.append((name, tuple(_value(a) for a in args)))
        return 0


@pytest.fixture
def launches(monkeypatch):
    lib = Launches()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(kernels, "selected",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "current_stream", lambda dev: STREAM)
    kernels.reset_launch_counts()
    tracing.reset_counters()
    yield lib
    kernels.reset_launch_counts()
    tracing.reset_counters()


@pytest.fixture
def wrappers_launch(monkeypatch, launches):
    """The kernel wrappers launch on CPU tensors too (into ``launches``),
    after their checks of tensor metadata."""
    def check(md, named, slots):
        kernels.check_slots(slots)
        kernels.check_tensors(named, md.device, md.dtype)
        return md.device

    monkeypatch.setattr(kernels, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(kernels, "_check", check)
    return launches


@functools.cache
def _mesh(preset: str):
    if preset == "cylinder":  # a small RCM-ordered cylinder
        return generate_cylinder_mesh(32, 16, 6)[0]
    return generate_planar_mesh(preset=preset)


def _cfg(iter_yn=False, dtype=torch.float32):
    return FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=2, iter_yn=iter_yn,
                        dtype=dtype)


def _md(preset="toy", dtype=torch.float32):
    return build_mesh_data(_mesh(preset), dtype, "cpu")


def _state(preset="toy", tb=None, dtype=torch.float32, seed=3) -> dict:
    fields = random_fields(_mesh(preset), seed=seed)
    if tb is not None:
        fields = {k: v if k in cstep.BATCH_SHARED
                  else np.stack([v * (t + 1) for t in range(tb)])
                  for k, v in fields.items()}
    return {k: torch.tensor(v, dtype=dtype) for k, v in fields.items()}


def _labels(md, state: dict, out: dict) -> dict:
    """Data pointer -> what it points at: a state field, a mesh data
    field or an output of the step."""
    names = {f: getattr(md, f) for f in ("area_inv", "edges", "nlev_edge",
                                         "ed_ptr", "nd_idx", "nd_other",
                                         "nd_lev", "nd_sgn", "nd_num",
                                         "nlev_nod")}
    labels = {t.data_ptr(): "md." + k for k, t in names.items()}
    labels.update({t.data_ptr(): "in." + k for k, t in state.items()})
    for k, t in out.items():
        if t is not None and t.data_ptr() not in labels:
            labels[t.data_ptr()] = "out." + k
    return labels


def _named(calls, labels: dict) -> list:
    return [(name, tuple(labels.get(a, a) for a in args))
            for name, args in calls]


# (fuse_k12, fuse_k34, Tb): every form, with and without a tracer axis
FORMS = [(False, True, None), (False, True, TB), (False, False, None),
         (False, False, TB), (True, True, None), (True, False, None),
         (True, True, TB), (True, False, TB)]


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("fuse_k12,fuse_k34,tb", FORMS)
def test_plan_launches_the_wrappers_arguments(wrappers_launch, fuse_k12,
                                              fuse_k34, tb, iter_yn):
    md, cfg, state = _md(), _cfg(iter_yn), _state(tb=tb)
    ref = cstep.fct_ale_step_cuda(md, cfg, state, fuse_k12=fuse_k12,
                                  fuse_k34=fuse_k34)
    want = _named(wrappers_launch.calls, _labels(md, state, ref))
    counts = kernels.launch_counts()
    wrappers_launch.calls.clear()
    kernels.reset_launch_counts()

    plans = cstep.StepPlans(fuse_k12=fuse_k12, fuse_k34=fuse_k34)
    plan = plans.plan(md, cfg, state)
    assert plan.fits(state, plan.first) and plan.fits(state, plan.rest)
    out = plan(state)
    got = _named(wrappers_launch.calls, _labels(md, state, out))
    assert got == want
    assert [n for n, _ in got] == [n for n, _ in want]
    assert all(args[-1] == STREAM for _, args in got)
    assert kernels.launch_counts() == counts
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        if v is None:
            assert out[k] is None, k
            continue
        assert (out[k].shape, out[k].dtype) == (v.shape, v.dtype), k
        assert out[k].is_contiguous(), k
        if k in state and v is state[k]:
            assert out[k] is state[k], k  # a field the step leaves
    want_counts = {"solver.plans_built": 1, "solver.plan_steps": 1}
    if fuse_k12:
        want_counts["solver.k12_steps"] = 1
    assert tracing.counters() == want_counts


def test_a_plan_is_built_once_per_signature(launches):
    md, cfg = _md(), _cfg()
    plans = cstep.StepPlans(fuse_k12=False, fuse_k34=True, batched=True)
    first, second = _state(tb=TB, seed=3), _state(tb=TB, seed=4)
    plan = plans.plan(md, cfg, first)
    assert plans.plan(md, cfg, second) is plan
    for state in (first, second, first):
        assert plan.fits(state, plan.first)
        plan(state)
    assert tracing.counters() == {"solver.plans_built": 1,
                                  "solver.plan_steps": 3}
    assert kernels.launch_counts()["update_fused"] == 3
    # three launches a step, each on the state it was given
    assert [n for n, _ in launches.calls] == [
        "fct_bounds_f32", "fct_limit_f32", "fct_update_fused_f32"] * 3
    assert launches.calls[3][1][0] == second["fct_LO"].data_ptr()


def test_a_new_signature_builds_a_new_plan(launches):
    plans = cstep.StepPlans()
    cfg, cfg64 = _cfg(), _cfg(dtype=torch.float64)
    md, md64, small = _md(), _md(dtype=torch.float64), _md("small")
    cases = [(md, cfg, _state(tb=TB)),                      # Tb = 2
             (md, cfg, _state(tb=3)),                       # Tb = 3
             (md, cfg, _state()),                           # no axis
             (md64, cfg64, _state(dtype=torch.float64)),    # float64
             (small, cfg, _state("small")),                 # other shapes
             (md, _cfg(iter_yn=True), _state())]            # other config
    built = [plans.plan(m, c, s) for m, c, s in cases]
    assert len({id(p) for p in built}) == len(cases)
    assert [p.tb for p in built] == [TB, 3, None, None, None, None]
    assert tracing.counters()["solver.plans_built"] == len(cases)
    again = [plans.plan(m, c, s) for m, c, s in cases]
    assert all(a is b for a, b in zip(again, built))
    assert tracing.counters()["solver.plans_built"] == len(cases)
    assert launches.calls == []  # building launches nothing


def _bad_states():
    """(what is wrong, field, the state, the error, its message)."""
    good = _state(tb=TB)
    out = []

    def bad(what, k, t, error, match):
        s = dict(good)
        s[k] = t
        out.append(pytest.param(k, s, error, match, id=f"{what}-{k}"))

    L, N = good["hnode"].shape
    bad("shape", "fct_adf_h", good["fct_adf_h"][:, :, 1:].contiguous(),
        ValueError, r"fct_adf_h has shape \(2, \d+, \d+\), expected")
    bad("shape", "hnode", good["hnode"][None].contiguous(), ValueError,
        rf"hnode has shape \(1, {L}, {N}\), expected \({L}, {N}\)")
    bad("dtype", "ttf", good["ttf"].double(), TypeError,
        "ttf has dtype torch.float64, expected torch.float32")
    bad("dtype", "del_ttf_advvert", good["del_ttf_advvert"].half(),
        TypeError, "del_ttf_advvert has dtype torch.float16")
    bad("device", "fct_LO", good["fct_LO"].to("meta"), ValueError,
        "fct_LO is on meta, mesh data on cpu")
    bad("device", "hnode_new", good["hnode_new"].to("meta"), ValueError,
        "hnode_new is on meta, mesh data on cpu")
    bad("contiguity", "fct_adf_v",
        good["fct_adf_v"].transpose(1, 2).contiguous().transpose(1, 2),
        ValueError, "fct_adf_v is not contiguous")
    bad("contiguity", "del_ttf_advhoriz",
        torch.stack([good["del_ttf_advhoriz"]] * 2, -1)[..., 0],
        ValueError, "del_ttf_advhoriz is not contiguous")
    return out


@pytest.mark.parametrize("field,state,error,match", _bad_states())
def test_the_plan_refuses_what_the_wrappers_refuse(launches, field, state,
                                                   error, match):
    md, cfg = _md(), _cfg()
    with pytest.raises(error, match=match):
        cstep.check_state(md, state)
    plans = cstep.StepPlans(fuse_k12=False, fuse_k34=True)
    with pytest.raises(error, match=match):
        plans.plan(md, cfg, state)
    plan = plans.plan(md, cfg, _state(tb=TB))
    fields = plan.first if field in ("fct_LO", "ttf") else plan.rest
    assert [k for k, _ in plan.first] == ["fct_LO", "ttf"]
    assert not plan.fits(state, fields)
    if field not in ("fct_LO", "ttf"):
        # refused after K1's launch, as the wrappers refuse it after theirs
        with pytest.raises(error, match=match):
            plan(state)
        assert [n for n, _ in launches.calls] == ["fct_bounds_f32"]
        assert kernels.launch_counts()["limit"] == 0


def test_a_shape_the_cpu_wrappers_check_raises_their_message():
    md, cfg = _md(), _cfg()
    state = _state(tb=TB)
    state["fct_adf_h"] = state["fct_adf_h"][:, :, 1:].contiguous()
    with pytest.raises(ValueError) as wrapper:
        cstep.fct_ale_step_cuda(md, cfg, state)
    with pytest.raises(ValueError) as planned:
        cstep.check_state(md, state)
    assert str(planned.value) == str(wrapper.value)


def test_the_check_follows_the_wrappers_other_refusals(launches):
    md = _md()
    with pytest.raises(ValueError, match="threads must be one of"):
        cstep.check_state(md, _state(), threads=96)
    none = _state(tb=TB)
    none["fct_LO"] = none["fct_LO"][:0]
    with pytest.raises(ValueError, match="at least one tracer"):
        cstep.check_state(md, none)
    assert cstep.check_state(md, _state(tb=TB)) == TB
    assert cstep.check_state(md, _state()) is None
    for k12, k34 in ((True, False), (True, True), (False, True)):
        plans = cstep.StepPlans(fuse_k12=k12, fuse_k34=k34, batched=True)
        with pytest.raises(ValueError, match=r"ttf as \[Tb, L, N\]"):
            plans(md, _cfg(), _state())
    # a batched K12 runs: on CPU mesh data, its plain version, a tracer
    # at a time
    state = _state(tb=TB)
    out = cstep.StepPlans(fuse_k12=True, batched=True)(md, _cfg(), state)
    for t in range(TB):
        one = cstep.fct_ale_step_cuda(
            md, _cfg(), {k: v if k in cstep.BATCH_SHARED else v[t]
                         for k, v in state.items()}, fuse_k12=True)
        assert torch.equal(out["fct_plus"][t], one["fct_plus"])


@pytest.mark.parametrize("batched", [False, True])
def test_cpu_mesh_data_runs_the_plain_versions(launches, batched):
    md, cfg = _md(), _cfg()
    state = _state(tb=TB)
    out = cstep.StepPlans(batched=batched)(md, cfg, state)
    ref = cstep.fct_ale_step_cuda(md, cfg, state)
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        assert v is None and out[k] is None or torch.equal(out[k], v), k
    assert launches.calls == [] and tracing.counters() == {}


class _NoKey(graphs.StepGraphs):
    def _key(self, *args):
        raise AssertionError("a run of fewer than 2 steps took a key")


@pytest.mark.parametrize("n", [0, 1])
def test_a_short_run_calls_the_step_without_a_key(n):
    calls = []

    def step(state):
        calls.append(state)
        return dict(state, extra=state["x"] + 1, x=state["x"] * 2)

    g = _NoKey("cuda:0")
    state = {"x": torch.ones(3)}
    out = g.run(step, state, n)
    assert len(calls) == n and out.keys() == state.keys()
    assert torch.equal(out["x"], torch.full((3,), 2.0 ** n))
    with pytest.raises(ValueError, match="n_steps must be >= 0"):
        g.run(step, state, -1)
    assert g.choices == {} and g._static == {}


def test_a_one_step_run_of_the_solver_takes_no_key(launches):
    """``run_tracers(state, 1)`` and ``run(state, 1)`` of a solver whose
    graphs are a CUDA device's, given plans on CPU mesh data: the step,
    its carry, no key."""
    cfg = _cfg()
    solver = FctAleSolver(_mesh("toy"), cfg, device="cpu")
    solver._step_fn = cstep.StepPlans()
    solver._tracer_step_fn = cstep.StepPlans(batched=True)
    solver._graphs = _NoKey("cuda:0")
    for run, step, state in ((solver.run_tracers, solver.step_tracers,
                              _state(tb=TB)),
                             (solver.run, solver.step, _state())):
        out = run(state, 1)
        ref = step(state)
        assert out.keys() == state.keys()
        for k in state:
            assert torch.equal(out[k], ref[k]), k
        zero = run(state, 0)
        assert all(zero[k] is v for k, v in state.items())


# the names of the launchers of each form, in launch order
K1_K2_K34 = ["fct_bounds_f32", "fct_limit_f32", "fct_update_fused_f32"]
K12_K34 = ["fct_limit_fused_f32", "fct_update_fused_f32"]
K1_K2_K3_K4 = ["fct_bounds_f32", "fct_limit_f32", "fct_b3h_f32",
               "fct_update_f32"]
K12_K3_K4 = ["fct_limit_fused_f32", "fct_b3h_f32", "fct_update_f32"]


@pytest.mark.parametrize("tb", [None, TB])
@pytest.mark.parametrize("preset", ["toy", "tiny", "small", "cylinder"])
def test_the_whole_mesh_step_takes_k12_k3_k4(launches, preset, tb):
    """Where the caller names no form, the plan of every mesh that the
    tier-1 tests build (planar and RCM-ordered, with none to a third of
    the live incidence slots' edges starting outside the node's tile)
    launches K12 -> K3 -> K4, at one tracer and at two, and each step
    counts once in solver.k12_steps as in solver.plan_steps."""
    md, cfg, state = _md(preset), _cfg(), _state(preset, tb=tb)
    plan = cstep.StepPlans(batched=tb is not None).plan(md, cfg, state)
    assert (plan.fuse_k12, plan.fuse_k34) == cstep.DEFAULT_FORM
    assert [k for k, _ in plan.first] == list(cstep.STEP_INPUTS[:4])
    for _ in range(3):
        plan(state)
    assert [n for n, _ in launches.calls] == K12_K3_K4 * 3
    assert tracing.counters() == {"solver.plans_built": 1,
                                  "solver.plan_steps": 3,
                                  "solver.k12_steps": 3}
    assert kernels.launch_counts()["limit_fused"] == 3
    # K12's launch takes the tracers it was given, 1 without the axis
    tail = launches.calls[0][1][-4:]
    assert tail[0] == (tb or 1) and tail[-1] == STREAM


@pytest.mark.parametrize("flags,names", [
    (dict(fuse_k12=False), K1_K2_K3_K4),
    (dict(fuse_k34=True), K12_K34),
    (dict(fuse_k12=False, fuse_k34=True), K1_K2_K34),
    (dict(fuse_k12=True, fuse_k34=False), K12_K3_K4),
])
def test_an_explicit_flag_chooses_its_form(launches, flags, names):
    md, cfg, state = _md("small"), _cfg(), _state("small", tb=TB)
    plan = cstep.StepPlans(batched=True, **flags).plan(md, cfg, state)
    plan(state)
    assert [n for n, _ in launches.calls] == names
    assert tracing.counters().get("solver.k12_steps", 0) == int(
        names[0] == "fct_limit_fused_f32")


@pytest.mark.parametrize("flags,form", [
    ({}, cstep.DEFAULT_FORM),
    (dict(fuse_k12=False), (False, False)),
    (dict(fuse_k34=True), (True, True)),
    (dict(fuse_k12=False, fuse_k34=True), (False, True)),
])
def test_the_solver_hands_its_flags_to_its_plans(monkeypatch, flags, form):
    """A CUDA solver's step and tracer step take the form of its flags,
    K12 -> K3 -> K4 where it is given none (its mesh data built on the
    CPU here: no card)."""
    monkeypatch.setattr(
        fct_ale_model, "build_mesh_data",
        lambda mesh, dtype, device: build_mesh_data(mesh, dtype, "cpu"))
    sv = FctAleSolver(_mesh("toy"), _cfg(), "cuda", device="cuda:0",
                      **flags)
    assert (sv.fuse_k12, sv.fuse_k34) == form
    for fn in (sv._step_fn, sv._tracer_step_fn):
        assert isinstance(fn, cstep.StepPlans)
        assert (fn.fuse_k12, fn.fuse_k34) == form
    assert sv._tracer_step_fn.batched and not sv._step_fn.batched
