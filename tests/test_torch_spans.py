"""PyTorch port: the program's spans (``runtime/tracing.py``).

* off unless a ``torch.profiler`` session records: ``span`` returns one
  shared object that does nothing and the record stays empty;
* on under a CPU profiler: names, ``parent`` and ``call`` of nested spans,
  a span closed by an exception, the cap and the count of dropped spans;
  each span's marker is on the profiler's host timeline and is not a user
  annotation (which would get a copy on the device's timeline);
* the shared clock: each span's ``time.time_ns()`` stamps against its
  marker's ``start_ns()`` / ``end_ns()`` in the profiler's events;
* the instrumented paths on the CPU: ``host_embed`` backend 0 with
  ``FESOM2_TORCH_DEVICE=cpu`` (``abi.step`` over ``abi.copy_in``,
  ``solver.pre_comm``, ``solver.inter_comm``, ``solver.post_comm``,
  ``abi.copy_out``), the step forms through the kernel
  wrappers' plain versions (``graphs.loop`` over ``solver.step`` over
  ``kernels.<wrapper>``), every wrapper a span, and the launch counts
  unchanged by tracing;
* the counters: on with no profiler, totals by name, a copy returned,
  cleared by ``reset_counters``.
"""

import functools
import inspect
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fesom2_accelerate_tpu_torch import host_embed
from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import (
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.model import FctAleSolver, Stress2RhsSolver
from fesom2_accelerate_tpu_torch.native import demo
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.cuda.step import fct_ale_step_cuda
from fesom2_accelerate_tpu_torch.runtime import tracing


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def markers(prof, names) -> list:
    """The profiler's host events of ``names``, by start."""
    return sorted((e for e in prof.profiler.kineto_results.events()
                   if e.name() in names), key=lambda e: e.start_ns())


def tree(spans) -> list:
    """(name, parent's name or None, root's name) of each span."""
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None,
             spans[s.call].name) for s in spans]


@pytest.fixture(autouse=True)
def empty_record():
    tracing.reset_spans()
    yield
    tracing.reset_spans()


@pytest.fixture(scope="module")
def toy():
    mesh = generate_planar_mesh(preset="toy")
    return mesh, random_fields(mesh, seed=3)


def cuda_step_solver(mesh, fuse_k12=False, fuse_k34=True):
    """A CPU solver given the CUDA step function: each kernel wrapper runs
    its plain version."""
    sv = FctAleSolver(mesh, FctAleConfig(dt=0.5, flux_eps=1e-7,
                                         dtype=torch.float32), device="cpu")
    sv._step_fn = functools.partial(fct_ale_step_cuda, fuse_k12=fuse_k12,
                                    fuse_k34=fuse_k34)
    return sv


def test_off_without_a_profiler(toy):
    mesh, fields = toy
    off = tracing.span("a")
    assert tracing.span("b") is off
    with off as entered:
        assert entered is off
    sv = cuda_step_solver(mesh)
    sv.run(sv.init_state(fields), 2)
    assert tracing.spans() == [] and tracing.dropped_spans() == 0


def test_nested_spans_under_a_profiler():
    @tracing.spanned("d")
    def fails():
        raise KeyError("inside d")

    with cpu_profile() as prof:
        assert tracing.span("a") is not tracing.span("a")
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with pytest.raises(KeyError):
                fails()
        with tracing.span("e"):
            with tracing.span("f"):
                pass
    spans = tracing.spans()
    assert [(s.name, s.parent, s.call) for s in spans] == [
        ("a", -1, 0), ("b", 0, 0), ("c", 1, 0), ("d", 0, 0), ("e", -1, 4),
        ("f", 4, 4)]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert spans[0].end_ns <= spans[4].start_ns
    ev = markers(prof, set("abcdef"))
    assert [e.name() for e in ev] == list("abcdef")
    assert not any(e.is_user_annotation() for e in ev)
    assert tracing.span("a") is tracing.span("b"), "off once it stopped"


def test_cap_and_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "SPAN_CAP", 3)
    with cpu_profile():
        with tracing.span("root"):
            for _ in range(4):
                with tracing.span("leaf"):
                    pass
    spans = tracing.spans()
    assert [s.name for s in spans] == ["root", "leaf", "leaf"]
    assert all(s.end_ns is not None for s in spans)
    assert tracing.dropped_spans() == 2
    tracing.reset_spans()
    assert tracing.spans() == [] and tracing.dropped_spans() == 0


def test_counters():
    tracing.reset_counters()
    tracing.count("a")
    tracing.count("a", 5)
    tracing.count("b", 2)
    got = tracing.counters()
    assert got == {"a": 6, "b": 2}
    got["a"] = 0
    assert tracing.counters()["a"] == 6
    tracing.reset_counters()
    assert tracing.counters() == {}


def test_stamps_on_the_profilers_clock():
    with cpu_profile() as prof:
        for _ in range(200):
            with tracing.span("clock.probe"):
                torch.zeros(16).add_(1.0)
    spans = tracing.spans()
    ev = markers(prof, {"clock.probe"})
    assert len(spans) == len(ev) == 200
    gaps = [abs(e.start_ns() - s.start_ns) for e, s in zip(ev, spans)] + [
        abs(e.end_ns() - s.end_ns) for e, s in zip(ev, spans)]
    assert statistics.median(gaps) <= 10_000
    assert statistics.quantiles(gaps, n=20)[-1] <= 50_000


def test_abi_step_spans(toy, monkeypatch):
    """Backend 0 (the plain f64 step) on the CPU through setup / step on
    caller-owned buffers."""
    mesh, fields = toy
    monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
    en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
    nl = np.ascontiguousarray(mesh.nlev_elem, np.int32)
    xy = np.ascontiguousarray(mesh.node_xy, np.float64)
    bufs = {k: np.array(fields[k], np.float64) for k, _ in demo.FIELD_FILES}
    try:
        assert host_embed.setup(mesh.n_elems, mesh.nl, en.ctypes.data,
                                nl.ctypes.data, mesh.n_nodes, xy.ctypes.data,
                                500, 1, 0, 0) == 0
        with cpu_profile():
            for _ in range(2):
                assert host_embed.step(*(bufs[k].ctypes.data
                                         for k, _ in demo.FIELD_FILES)) == 0
    finally:
        host_embed.reset()
    one = [("abi.step", None, "abi.step"),
           ("abi.copy_in", "abi.step", "abi.step"),
           ("solver.pre_comm", "abi.step", "abi.step"),
           ("solver.inter_comm", "abi.step", "abi.step"),
           ("solver.post_comm", "abi.step", "abi.step"),
           ("abi.copy_out", "abi.step", "abi.step")]
    spans = tracing.spans()
    assert tree(spans) == one * 2
    assert spans[6].call == 6


@pytest.mark.parametrize("form, wrappers", [
    ((False, True), ["bounds", "limit", "update_fused"]),
    ((True, True), ["limit_fused", "update_fused"]),
    ((False, False), ["bounds", "limit", "b3h", "update"]),
])
def test_step_form_spans(toy, form, wrappers):
    mesh, fields = toy
    sv = cuda_step_solver(mesh, *form)
    state = sv.init_state(fields)
    kernels.reset_launch_counts()
    plain = sv.run(state, 2)
    counts = kernels.launch_counts()
    with cpu_profile():
        traced = sv.run(state, 2)
    assert kernels.launch_counts() == counts
    for k, v in plain.items():
        assert torch.equal(traced[k], v), k
    step = [("solver.step", "graphs.loop", "graphs.loop")] + [
        (f"kernels.{w}", "solver.step", "graphs.loop") for w in wrappers]
    assert tree(tracing.spans()) == [
        ("graphs.loop", None, "graphs.loop")] + step * 2


def test_stress2rhs_span(toy):
    mesh, _ = toy
    sv = Stress2RhsSolver(mesh, torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    E, N = mesh.n_elems, mesh.n_nodes
    packed = sv.pack_elem_inputs(*rng.random((5, E)), rng.random((6, E)),
                                 rng.random(E))
    node = [torch.tensor(rng.random(N)) for _ in range(3)]
    with cpu_profile():
        u, v = kernels.stress2rhs(sv.md, packed, *node)
    want = kernels.stress2rhs_ref(sv.md, packed, *node)
    assert torch.equal(u, want[0]) and torch.equal(v, want[1])
    assert tree(tracing.spans()) == [("kernels.stress2rhs", None,
                                      "kernels.stress2rhs")]


@pytest.mark.parametrize("wrapper", kernels.WRAPPERS,
                         ids=lambda w: w.__name__)
def test_every_wrapper_is_a_span(wrapper):
    """A call that fails its checks (no mesh data) is still the wrapper's
    span, closed, and launches nothing."""
    kernels.reset_launch_counts()
    n = sum(p.default is p.empty and p.kind is p.POSITIONAL_OR_KEYWORD
            for p in inspect.signature(wrapper).parameters.values())
    with cpu_profile():
        with pytest.raises(AttributeError):
            wrapper(*[None] * n)
    spans = tracing.spans()
    assert [s.name for s in spans] == [f"kernels.{wrapper.__name__}"]
    assert spans[0].end_ns is not None
    assert sum(kernels.launch_counts().values()) == 0

