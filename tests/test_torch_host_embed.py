"""PyTorch port: the host-embedding C ABI (``native/fesom2_torch_host.cpp``
over ``host_embed``), the counterpart of tests/test_native.py:108-181.

* the port's C demo host, built with g++ and linked against the port's
  shim, runs one step on the ``toy`` mesh through ``f2t_*_`` only:
  backend 0 (the plain torch f64 step), asked for on the CPU with
  ``FESOM2_TORCH_DEVICE=cpu``, bit for bit against
  ``FctAleSolver(device="cpu")`` in f64, and against the JAX f64 solver at
  1e-12, with ``iter_yn`` both ways;
* either backend on a host without a card, backend 0 not asked for on the
  CPU, and backend 1 asked for the CPU: ``istat`` 1 from setup, and the
  message names the missing device; nothing falls back to the CPU and
  nothing stands in for the kernels; an unknown ``FESOM2_TORCH_DEVICE``
  fails setup and is named;
* ``_solver`` gives backend 0 the plain stages (``backend="torch"``) on
  the device asked for, backend 1 the kernels on the card (the card's half
  runs in ``chip_smoke.py`` phase 12);
* backend 1's Python ``step`` on the CPU, given the CUDA step function
  (each kernel wrapper's plain version), against the JAX
  ``FctAleSolver(backend="pallas")`` in interpret mode at 2e-6;
* the port's ``extern "C"`` block declares the names and parameter lists
  of the JAX package's ``native/fesom2_tpu_host.cpp`` (a text check);
* ``build_mesh_from_elements`` keeps the edge order H-K34 needs on the
  host's elements;
* the registry of page-locked buffers (``host_embed.Pins``), with
  ``cudaHostRegister`` / ``cudaHostUnregister`` replaced by fakes and the
  solver's device reported as a card (the solver a CPU one, streams and
  events faked): each buffer registered once across steps and tracers,
  ``hnode`` / ``hnode_new`` shared, one wait for each stream a step, the
  buffers bit for bit those of a witness that casts on the host; two
  buffers on one page both registered; a changed size registered anew; a
  refused registration counts the buffer's bytes under
  ``abi.bytes_pageable``; backend 1 counts every byte it moves under
  ``abi.bytes_cast`` too; ``reset`` (and a new ``setup``) unregisters
  everything; a CPU solver registers nothing;
* the copy plan (``host_embed.INPUTS``, ``RESULTS``) holds each input and
  each result once, for both backends and ``iter_yn`` values, and each
  result it takes early is final after its phase; a session on the CPU
  takes no stream, backend 0 on a card the three streams, and neither
  counts an early byte; ``step`` never calls ``FctAleSolver.step``; a
  step on fake streams and events enqueues every copy in plan order,
  each phase behind the copies it reads, each result behind the phase
  that finalises it, waits for every stream, also where a phase raises,
  and gives the witness's bits.
  The card's half is ``tests/test_torch_host_embed_card.py``.

The build is skipped only where g++ or libpython is absent, as
tests/test_native.py skips."""

import mmap
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.config import FctAleConfig as JaxFctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver as JaxFctAleSolver
from fesom2_accelerate_tpu.ops.pallas import kernels as pallas_kernels
from fesom2_accelerate_tpu_torch import host_embed
from fesom2_accelerate_tpu_torch.mesh import (
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.mesh.topology import (
    build_mesh_from_elements,
)
from fesom2_accelerate_tpu_torch.model import FctAleSolver
from fesom2_accelerate_tpu_torch.model.fct_ale import PHASES
from fesom2_accelerate_tpu_torch.native import build, demo
from fesom2_accelerate_tpu_torch.ops.cuda.step import fct_ale_step_cuda
from fesom2_accelerate_tpu_torch.ops.meshdata import check_edge_order
from fesom2_accelerate_tpu_torch.runtime import tracing

from conftest import masked_allclose

REPO = pathlib.Path(__file__).resolve().parents[1]
F32_RELERR = 2e-6  # tests/test_native.py:181
DT_MILLI = 500


@pytest.fixture(scope="module")
def toy():
    mesh = generate_planar_mesh(preset="toy")
    return mesh, random_fields(mesh, seed=5)


@pytest.fixture(scope="module")
def demo_exe():
    if not build.available():
        pytest.skip("host embedding shim unavailable (no g++ or libpython)")
    return build.build()[1]


def _jax(iter_yn, backend, fields):
    if backend == "pallas":
        cfg = JaxFctAleConfig(dt=DT_MILLI * 1e-3, vlimit=1, iter_yn=iter_yn,
                              dtype=jnp.float32, flux_eps=1e-7)
    else:
        cfg = JaxFctAleConfig(dt=DT_MILLI * 1e-3, vlimit=1, iter_yn=iter_yn,
                              dtype=jnp.float64)
    pallas_kernels.set_interpret(backend == "pallas")
    try:
        solver = JaxFctAleSolver(jax_planar_mesh(preset="toy"), cfg,
                                 backend=backend)
        return {k: np.asarray(v)
                for k, v in solver.step(solver.init_state(fields)).items()}
    finally:
        pallas_kernels.set_interpret(False)


def _setup(mesh, backend: int, iter_yn: bool = False) -> int:
    """``host_embed.setup`` on the mesh's host arrays -> its istat."""
    en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
    nl = np.ascontiguousarray(mesh.nlev_elem, np.int32)
    xy = np.ascontiguousarray(mesh.node_xy, np.float64)
    return host_embed.setup(mesh.n_elems, mesh.nl, en.ctypes.data,
                            nl.ctypes.data, mesh.n_nodes, xy.ctypes.data,
                            DT_MILLI, 1, int(iter_yn), backend)


@pytest.mark.parametrize("iter_yn", [False, True])
def test_c_demo_backend0_matches_port_and_jax(tmp_path, toy, demo_exe,
                                              monkeypatch, iter_yn):
    mesh, fields = toy
    monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
    demo.write_inputs(tmp_path, mesh, fields, DT_MILLI, 1, iter_yn, 0)
    p = demo.run(demo_exe, tmp_path)
    assert p.returncode == 0, f"demo failed:\n{p.stdout}\n{p.stderr[-3000:]}"
    assert f"nodes={mesh.n_nodes} edges={mesh.n_edges}" in p.stdout
    got = demo.outputs(tmp_path, mesh, iter_yn)

    solver = FctAleSolver(mesh, host_embed.config(0, DT_MILLI, 1, iter_yn),
                          device="cpu")
    ref = solver.step(solver.init_state(fields))
    jref = _jax(iter_yn, "xla", fields)
    assert set(got) == ({"fct_adf_v", "fct_adf_h"} | (
        {"fct_LO"} if iter_yn else {"del_ttf_advvert", "del_ttf_advhoriz"}))
    for k, v in got.items():
        np.testing.assert_array_equal(v, ref[k].numpy(), err_msg=k)
        masked_allclose(v, jref[k], msg=f"jax[{k}]")


def test_backend1_without_a_card_fails_setup(tmp_path, toy, demo_exe,
                                             capsys, monkeypatch):
    mesh, fields = toy
    # through the C host: f2t_setup_ gives istat 1, the demo exits 4
    demo.write_inputs(tmp_path, mesh, fields, DT_MILLI, 1, False, 1)
    p = demo.run(demo_exe, tmp_path)
    assert p.returncode == 4, p.stdout + p.stderr
    assert "needs a CUDA device" in p.stderr
    # the same call from Python, with the card hidden where there is one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
    nl = np.ascontiguousarray(mesh.nlev_elem, np.int32)
    xy = np.ascontiguousarray(mesh.node_xy, np.float64)
    assert host_embed.setup(mesh.n_elems, mesh.nl, en.ctypes.data,
                            nl.ctypes.data, mesh.n_nodes, xy.ctypes.data,
                            DT_MILLI, 1, 0, 1) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="setup has not succeeded"):
        host_embed.dims()


def test_backend0_without_a_card_fails_setup(tmp_path, toy, demo_exe,
                                             capsys, monkeypatch):
    """With no card and no request for the CPU, backend 0 refuses: it does
    not carry on on the CPU."""
    mesh, fields = toy
    monkeypatch.delenv(host_embed.DEVICE_ENV, raising=False)
    # through the C host, the card hidden: istat 1, the demo exits 4
    demo.write_inputs(tmp_path, mesh, fields, DT_MILLI, 1, False, 0)
    p = demo.run(demo_exe, tmp_path, env={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 4, p.stdout + p.stderr
    assert "backend 0" in p.stderr and "needs a CUDA device" in p.stderr
    # from Python, with the card hidden where there is one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _setup(mesh, 0) == 1
    err = capsys.readouterr().err
    assert "needs a CUDA device" in err and host_embed.DEVICE_ENV in err
    with pytest.raises(RuntimeError, match="setup has not succeeded"):
        host_embed.dims()


@pytest.mark.parametrize("backend", [0, 1])
@pytest.mark.parametrize("value", ["gpu", "CPU", ""])
def test_unknown_device_request_fails_setup(toy, capsys, monkeypatch,
                                            backend, value):
    mesh, _ = toy
    monkeypatch.setenv(host_embed.DEVICE_ENV, value)
    assert _setup(mesh, backend) == 1
    assert f"{host_embed.DEVICE_ENV}={value!r}" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="setup has not succeeded"):
        host_embed.dims()


def test_backend1_asked_for_the_cpu_fails_setup(tmp_path, toy, demo_exe,
                                                capsys, monkeypatch):
    """The kernels need the card: ``FESOM2_TORCH_DEVICE=cpu`` does not move
    backend 1 to the CPU, even where a card exists."""
    mesh, fields = toy
    demo.write_inputs(tmp_path, mesh, fields, DT_MILLI, 1, False, 1)
    p = demo.run(demo_exe, tmp_path, env={host_embed.DEVICE_ENV: "cpu"})
    assert p.returncode == 4, p.stdout + p.stderr
    assert f"{host_embed.DEVICE_ENV}=cpu" in p.stderr
    monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _setup(mesh, 1) == 1
    err = capsys.readouterr().err
    assert "needs a CUDA device" in err and host_embed.DEVICE_ENV in err


def test_backend0_solver_is_the_plain_step_on_the_cpu_asked_for(
        toy, monkeypatch):
    mesh, fields = toy
    monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
    cfg = host_embed.config(0, DT_MILLI, 1, 0)
    solver = host_embed._solver(mesh, cfg, 0)
    assert solver.backend == "torch" and solver.device == torch.device("cpu")
    assert solver.md.edges.device.type == "cpu"
    ref = FctAleSolver(mesh, cfg, "torch", device="cpu")
    got = solver.step(solver.init_state(fields))
    for k, v in ref.step(ref.init_state(fields)).items():
        assert got[k].dtype == torch.float64
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("backend, asked, want", [
    (0, None, ("torch", "cuda")), (0, "cuda", ("torch", "cuda")),
    (0, "cpu", ("torch", "cpu")), (1, None, ("cuda", "cuda")),
    (1, "cuda", ("cuda", "cuda"))])
def test_solver_backend_and_device(toy, monkeypatch, backend, asked, want):
    """The (backend, device) ``_solver`` builds for each backend and
    ``FESOM2_TORCH_DEVICE``, a card reported present (the solver is not
    built, so no card is needed)."""
    mesh, _ = toy
    if asked is None:
        monkeypatch.delenv(host_embed.DEVICE_ENV, raising=False)
    else:
        monkeypatch.setenv(host_embed.DEVICE_ENV, asked)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = []
    monkeypatch.setattr(host_embed, "FctAleSolver",
                        lambda m, c, b, *, device: built.append((b, device)))
    host_embed._solver(mesh, host_embed.config(backend, DT_MILLI, 1, 0),
                       backend)
    assert built == [(want[0], torch.device(want[1]))]


@pytest.mark.parametrize("iter_yn", [False, True])
def test_backend1_step_on_cpu_matches_jax_pallas(toy, monkeypatch, iter_yn):
    """Backend 1 through ``setup`` / ``step`` on caller-owned f64 buffers,
    its solver a CPU one given the CUDA step function."""
    mesh, fields = toy

    def cpu_solver(mesh, cfg, backend):
        assert backend == 1 and cfg.dtype == torch.float32
        solver = FctAleSolver(mesh, cfg, device="cpu")
        solver._step_fn = fct_ale_step_cuda
        return solver

    monkeypatch.setattr(host_embed, "_solver", cpu_solver)
    en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
    nl = np.ascontiguousarray(mesh.nlev_elem, np.int32)
    xy = np.ascontiguousarray(mesh.node_xy, np.float64)
    try:
        assert host_embed.setup(mesh.n_elems, mesh.nl, en.ctypes.data,
                                nl.ctypes.data, mesh.n_nodes, xy.ctypes.data,
                                DT_MILLI, 1, int(iter_yn), 1) == 0
        assert host_embed.dims() == (mesh.n_nodes, mesh.n_edges,
                                     mesh.n_layers)
        bufs = {k: np.array(fields[k], np.float64)
                for k, _ in demo.FIELD_FILES}
        before = {k: v.copy() for k, v in bufs.items()}
        assert host_embed.step(*(bufs[k].ctypes.data
                                 for k, _ in demo.FIELD_FILES)) == 0
    finally:
        host_embed.reset()
    jref = _jax(iter_yn, "pallas", fields)
    written = {"fct_adf_v", "fct_adf_h"} | (
        {"fct_LO"} if iter_yn else {"del_ttf_advvert", "del_ttf_advhoriz"})
    for k, v in bufs.items():
        if k not in written:
            np.testing.assert_array_equal(v, before[k], err_msg=k)
            continue
        ref = jref[k][:v.shape[0]]
        err = np.abs(v - ref).max() / max(np.abs(ref).max(), 1.0)
        assert err < F32_RELERR, f"{k}: relerr {err:.2e}"
        assert not np.array_equal(v, before[k]), k


def _extern_c(path: pathlib.Path) -> dict:
    """name -> parameter list (whitespace collapsed) of each function
    defined in the file's ``extern "C"`` block."""
    text = path.read_text()
    block = text[text.index('extern "C" {'):]
    sigs = re.findall(r"void\s+(f2t_\w+)\s*\(([^)]*)\)\s*\{", block)
    return {name: " ".join(params.split()) for name, params in sigs}


def test_c_surface_matches_jax_shim():
    """The JAX shim's five entry points with its parameter lists, and the
    three of a rank's partition beside them."""
    port = REPO / "fesom2_accelerate_tpu_torch" / "native"
    ours = _extern_c(port / "fesom2_torch_host.cpp")
    jax_shim = _extern_c(REPO / "native" / "fesom2_tpu_host.cpp")
    assert {n: ours[n] for n in jax_shim} == jax_shim
    assert set(jax_shim) == {"f2t_init_", "f2t_setup_", "f2t_dims_",
                             "f2t_fct_ale_step_", "f2t_finalize_"}
    assert set(ours) - set(jax_shim) == {
        "f2t_setup_part_", "f2t_fct_ale_pre_comm_", "f2t_fct_ale_post_comm_"}
    # the partition's set-up: f2t_setup_'s parameters, n_owned after
    # n_nodes; the phases: the step's buffers, then the two factors
    setup = ours["f2t_setup_"].split(", ")
    i = setup.index("const int *n_nodes") + 1
    assert ours["f2t_setup_part_"].split(", ") == \
        setup[:i] + ["const int *n_owned"] + setup[i:]
    step = ours["f2t_fct_ale_step_"].split(", ")
    assert ours["f2t_fct_ale_pre_comm_"].split(", ") == step[:-1] + [
        "double *fct_plus", "double *fct_minus", "int *istat"]
    assert ours["f2t_fct_ale_post_comm_"].split(", ") == step[:-1] + [
        "const double *fct_plus", "const double *fct_minus", "int *istat"]
    # the demo host declares the JAX shim's surface
    decls = re.findall(r"void\s+(f2t_\w+)\s*\(([^)]*)\);",
                       (port / "host_embed_demo.cpp").read_text())
    assert {n: " ".join(p.split()) for n, p in decls} == jax_shim
    # the shim imports the port, never the JAX package
    src = (port / "fesom2_torch_host.cpp").read_text()
    assert '"fesom2_accelerate_tpu_torch.host_embed"' in src
    assert "std::call_once" in src


@pytest.mark.parametrize("preset", ["toy", "tiny", "small"])
def test_host_built_mesh_keeps_edge_order(preset):
    """The mesh ``setup`` builds from the host's elements has the planar
    mesh's edges, in the order H-K34's edge ranges need."""
    mesh = generate_planar_mesh(preset=preset)
    host = build_mesh_from_elements(mesh.elem_nodes, mesh.nlev_elem,
                                    mesh.nl, mesh.node_xy)
    np.testing.assert_array_equal(host.edges, mesh.edges)
    assert check_edge_order(torch.from_numpy(host.edges)) == mesh.n_edges


# ---- the registry of page-locked buffers, on the CPU -------------------

PAGE = mmap.PAGESIZE
SHARED = ("hnode", "hnode_new")


def _own_pages(a: np.ndarray) -> np.ndarray:
    """A copy of ``a`` on pages of its own, as a large host array's are."""
    raw = np.empty(-(-a.nbytes // PAGE) * PAGE + PAGE, np.uint8)
    off = -raw.ctypes.data % PAGE
    out = raw[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def _tracer_buffers(mesh, tracers: int = 2) -> list:
    """Each tracer's eight f64 buffers, each on pages of its own,
    ``hnode`` and ``hnode_new`` shared by the tracers."""
    bufs = []
    for t in range(tracers):
        fields = random_fields(mesh, seed=5 + t)
        bufs.append({k: bufs[0][k] if t and k in SHARED
                     else _own_pages(np.asarray(fields[k], np.float64))
                     for k, _ in demo.FIELD_FILES})
    return bufs


def _outputs(iter_yn: bool) -> list:
    return ["fct_adf_v", "fct_adf_h"] + (
        ["fct_LO"] if iter_yn else ["del_ttf_advvert", "del_ttf_advhoriz"])


def _pageable_steps(solver, iter_yn: bool, bufs: list, steps: int) -> list:
    """Copies of ``bufs`` after ``steps`` steps of every tracer through the
    witness's copies, pageable and cast on the host: ``init_state``, the
    step, ``.cpu()`` and numpy's write."""
    shared = {k: bufs[0][k].copy() for k in SHARED}
    got = [dict({k: v.copy() for k, v in b.items() if k not in SHARED},
                **shared) for b in bufs]
    for _ in range(steps):
        for b in got:
            out = solver.step(solver.init_state(b))
            for k in _outputs(iter_yn):
                np.copyto(b[k], out[k].cpu().numpy())
    return got


def _assert_same_bits(got: dict, want: dict) -> None:
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].view(np.uint64),
                                      v.view(np.uint64), err_msg=k)


class FakeCudart:
    """``cudaHostRegister`` / ``cudaHostUnregister`` that record their
    calls.  A registration of an address in ``refuse`` fails with the code
    it maps to (1, ``cudaErrorInvalidValue``; 712,
    ``cudaErrorHostMemoryAlreadyRegistered``); as CUDA on the card, a page
    two buffers share is locked for each."""

    def __init__(self, refuse=None):
        self.tries, self.registered, self.unregistered = [], [], []
        self.refuse = dict(refuse or {})
        self.live: dict = {}

    def cudaHostRegister(self, addr, n, flags):
        assert flags == 0
        self.tries.append(addr)
        if addr in self.refuse:
            return self.refuse[addr]
        self.registered.append((addr, n))
        self.live[addr] = n
        return 0

    def cudaHostUnregister(self, addr):
        assert addr in self.live
        del self.live[addr]
        self.unregistered.append(addr)
        return 0


PHASE_ORDER = ("pre_comm", "inter_comm", "post_comm")


class FakeStreams:
    """``torch.cuda``'s streams, events and stream context, and
    ``Tensor.record_stream``, as fakes that log what each stream is given:
    a call's order on the card, on the CPU.  The solver's three phases log
    their runs on the current stream."""

    def __init__(self, monkeypatch):
        self.log, self.current, self.events = [], None, 0
        fake = self

        class Stream:
            def __init__(self, name):
                self.name = name

            def wait_stream(self, other):
                fake.log.append((self.name, "wait_stream", other.name))

            def wait_event(self, event):
                fake.log.append((self.name, "wait", event.n))

            def synchronize(self):
                fake.log.append((self.name, "sync"))

        class Event:
            def __init__(self):
                fake.events += 1
                self.n = fake.events

            def record(self, stream):
                fake.log.append((stream.name, "record", self.n))

            def synchronize(self):
                fake.log.append(("host", "event_sync", self.n))

        def stream(s):
            class Context:
                def __enter__(self):
                    self.old = fake.current
                    fake.current = s or fake.current

                def __exit__(self, *exc):
                    fake.current = self.old

            return Context()

        made = iter(["copy", "back"])
        self.current = Stream("compute")
        monkeypatch.setattr(torch.cuda, "Stream",
                            lambda device=None: Stream(next(made)))
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "stream", stream)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: fake.current)
        monkeypatch.setattr(torch.Tensor, "record_stream",
                            lambda t, s: fake.log.append(
                                (fake.current.name, "record_stream", s.name)),
                            raising=False)

    def on(self, name: str) -> list:
        return [e[1:] for e in self.log if e[0] == name]

    def syncs(self) -> dict:
        return {n: self.on(n).count(("sync",))
                for n in ("compute", "copy", "back")}


class Card:
    """The solver's device reported as a card: the registry on, its cudart
    faked, streams and events faked (:class:`FakeStreams`, ``fake``), the
    solver a CPU one whose three phases log their runs (the phase ``fail``
    raising instead): backend 0 the plain f64 stages, backend 1 the CUDA
    phases' plain versions (its step the CUDA step function's)."""

    def __init__(self, monkeypatch, cudart: FakeCudart,
                 fail: str | None = None):
        self.cudart, self.cleared = cudart, 0
        self.fake = fake = FakeStreams(monkeypatch)
        card = self

        def logged(name, run):
            def phase(*args):
                fake.log.append((fake.current.name, "run", name))
                if name == fail:
                    raise RuntimeError(f"{name} failed")
                return run(*args)
            return phase

        def cpu_solver(mesh, cfg, backend):
            if backend == 0:
                solver = FctAleSolver(mesh, cfg, "torch", device="cpu")
            else:
                solver = FctAleSolver(mesh, cfg, device="cpu")
                solver._step_fn = fct_ale_step_cuda
                solver._phases = PHASES["cuda"]
                solver.backend = "cuda"
            for name in PHASE_ORDER:
                monkeypatch.setattr(solver, name,
                                    logged(name, getattr(solver, name)))
            return solver

        def clear_error(device):
            card.cleared += 1

        monkeypatch.setattr(host_embed, "_solver", cpu_solver)
        monkeypatch.setattr(host_embed, "_pinnable", lambda device: True)
        monkeypatch.setattr(host_embed, "_cudart", lambda: cudart)
        monkeypatch.setattr(host_embed, "_clear_error", clear_error)
        tracing.reset_counters()

    @staticmethod
    def steps(bufs: list, steps: int) -> None:
        for _ in range(steps):
            for b in bufs:
                assert host_embed.step(*(b[k].ctypes.data
                                         for k, _ in demo.FIELD_FILES)) == 0


def _moved(bufs: list, iter_yn: bool) -> int:
    """The bytes one step of every tracer moves: eight buffers in, the
    results out."""
    return sum(sum(b[k].nbytes for k, _ in demo.FIELD_FILES)
               + sum(b[k].nbytes for k in _outputs(iter_yn)) for b in bufs)


def _out(bufs: list, iter_yn: bool) -> int:
    """The result bytes one step of every tracer writes back."""
    return sum(b[k].nbytes for b in bufs for k in _outputs(iter_yn))


def _casts(backend: int, moved: int) -> dict:
    """The counter ``abi.bytes_cast`` of a session that moved ``moved``
    bytes: backend 1 casts every one between the host's f64 and f32;
    backend 0 (f64) none, so it has no key."""
    return {"abi.bytes_cast": moved} if backend == 1 else {}


def _early(bufs: list, backend: int, steps: int) -> dict:
    """The counter ``abi.bytes_out_early`` after ``steps`` steps of every
    tracer on a card: backend 1 writes back the fluxes K2 and K3 finalise
    early; backend 0 (the plain stages) nothing, so it has no key."""
    if backend == 0:
        return {}
    return {"abi.bytes_out_early": steps * sum(
        b[k].nbytes for b in bufs for k in ("fct_adf_v", "fct_adf_h"))}


@pytest.mark.parametrize("backend", [0, 1])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_each_buffer_registered_once(toy, monkeypatch, backend, iter_yn):
    """Two tracers, three steps: 14 registrations (``hnode`` and
    ``hnode_new`` once), every byte from and to registered memory, a
    synchronize of each of the three streams a step, the buffers bit for
    bit the witness's."""
    mesh, _ = toy
    card = Card(monkeypatch, FakeCudart())
    bufs = _tracer_buffers(mesh)
    try:
        assert _setup(mesh, backend, iter_yn) == 0
        want = _pageable_steps(host_embed.session().solver, iter_yn, bufs, 3)
        card.steps(bufs, 3)
        refused = dict(host_embed.session().pins.refused)
    finally:
        host_embed.reset()
    distinct = {b[k].ctypes.data: b[k].nbytes for b in bufs for k in b}
    assert len(distinct) == 14
    assert sorted(card.cudart.registered) == sorted(distinct.items())
    assert {bufs[0][k].ctypes.data for k in SHARED} == {
        bufs[1][k].ctypes.data for k in SHARED}
    assert not refused and card.cleared == 0
    assert card.fake.syncs() == {"compute": 6, "copy": 6, "back": 6}
    assert tracing.counters() == {"abi.bytes_registered":
                                  3 * _moved(bufs, iter_yn),
                                  "abi.bytes_out": 3 * _out(bufs, iter_yn),
                                  **_early(bufs, backend, 3),
                                  **_casts(backend, 3 * _moved(bufs,
                                                               iter_yn))}
    for got, w in zip(bufs, want):
        _assert_same_bits(got, w)


@pytest.mark.parametrize("code", [1, 712])
def test_refused_registration_takes_the_pageable_path(toy, monkeypatch,
                                                      code):
    """A buffer CUDA refuses (``fct_adf_h``: in and out; refused by the
    driver, or locked by the caller already) is copied from and to
    pageable memory, is not tried again, and counts its bytes under
    ``abi.bytes_pageable``; the others stay registered, and the buffers
    are the witness's bit for bit."""
    mesh, _ = toy
    bufs = _tracer_buffers(mesh, tracers=1)
    b = bufs[0]
    key = "fct_adf_h"
    addr = b[key].ctypes.data
    cudart = FakeCudart(refuse={addr: code})
    card = Card(monkeypatch, cudart)
    try:
        assert _setup(mesh, 1) == 0
        want = _pageable_steps(host_embed.session().solver, False, bufs, 2)
        card.steps(bufs, 2)
        refused = dict(host_embed.session().pins.refused)
    finally:
        host_embed.reset()
    assert refused == {addr: b[key].nbytes}
    assert cudart.tries.count(addr) == 1 and card.cleared == 1
    assert {a for a, _ in cudart.registered} == {
        v.ctypes.data for k, v in b.items() if k != key}
    pageable = 2 * 2 * b[key].nbytes
    assert tracing.counters() == {
        "abi.bytes_pageable": pageable,
        "abi.bytes_registered": 2 * _moved(bufs, False) - pageable,
        "abi.bytes_out": 2 * _out(bufs, False), **_early(bufs, 1, 2),
        **_casts(1, 2 * _moved(bufs, False))}
    _assert_same_bits(b, want[0])


def test_a_shared_page_registers_both(toy, monkeypatch):
    """``ttf`` and ``fct_LO`` end to end on one page: both registered, as
    CUDA locks a shared page for each (the card test shows it), every byte
    from and to registered memory, the buffers the witness's bit for
    bit."""
    mesh, _ = toy
    bufs = _tracer_buffers(mesh, tracers=1)
    b = bufs[0]
    n = b["ttf"].size
    assert b["ttf"].nbytes % PAGE
    pair = _own_pages(np.concatenate([b["ttf"].ravel(),
                                      b["fct_LO"].ravel()]))
    b["ttf"] = pair[:n].reshape(b["ttf"].shape)
    b["fct_LO"] = pair[n:].reshape(b["fct_LO"].shape)
    card = Card(monkeypatch, FakeCudart())
    try:
        assert _setup(mesh, 1) == 0
        want = _pageable_steps(host_embed.session().solver, False, bufs, 2)
        card.steps(bufs, 2)
    finally:
        host_embed.reset()
    assert sorted(card.cudart.registered) == sorted(
        (v.ctypes.data, v.nbytes) for v in b.values())
    assert tracing.counters() == {"abi.bytes_registered":
                                  2 * _moved(bufs, False),
                                  "abi.bytes_out": 2 * _out(bufs, False),
                                  **_early(bufs, 1, 2),
                                  **_casts(1, 2 * _moved(bufs, False))}
    _assert_same_bits(b, want[0])


def test_changed_size_registers_anew(monkeypatch):
    """The same address with another byte count: unregistered, then
    registered at its new size, once."""
    cudart = FakeCudart()
    monkeypatch.setattr(host_embed, "_cudart", lambda: cudart)
    pins = host_embed.Pins(torch.device("cpu"))
    a = _own_pages(np.zeros(3 * PAGE // 8))
    assert pins.pinned(a[:PAGE // 8]) and pins.pinned(a[:PAGE // 8])
    assert pins.pinned(a) and pins.pinned(a)
    addr = a.ctypes.data
    assert cudart.registered == [(addr, PAGE), (addr, 3 * PAGE)]
    assert cudart.unregistered == [addr]
    assert pins.held == {addr: 3 * PAGE}


@pytest.mark.parametrize("end", ["reset", "setup"])
def test_reset_unregisters_everything(toy, monkeypatch, end):
    """``reset`` (``f2t_finalize_``), and a new ``setup``, unregister every
    buffer the session registered."""
    mesh, _ = toy
    card = Card(monkeypatch, FakeCudart())
    bufs = _tracer_buffers(mesh)
    try:
        assert _setup(mesh, 1) == 0
        card.steps(bufs, 1)
        assert len(card.cudart.registered) == 14
        assert not card.cudart.unregistered
        if end == "reset":
            assert host_embed.reset() == 0
        else:
            assert _setup(mesh, 1) == 0
            assert host_embed.session().pins.held == {}
    finally:
        host_embed.reset()
    assert sorted(card.cudart.unregistered) == sorted(
        a for a, _ in card.cudart.registered)


def test_cpu_solver_never_registers(toy, monkeypatch):
    """Backend 0 on the CPU registers nothing: no registry, no call of
    cudart, every byte under ``abi.bytes_pageable``, the buffers the
    witness's bit for bit."""
    mesh, _ = toy
    monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")

    def no_cudart():
        raise AssertionError("a CPU solver called cudart")

    monkeypatch.setattr(host_embed, "_cudart", no_cudart)
    tracing.reset_counters()
    bufs = _tracer_buffers(mesh)
    try:
        assert _setup(mesh, 0) == 0
        assert host_embed.session().pins is None
        want = _pageable_steps(host_embed.session().solver, False, bufs, 2)
        Card.steps(bufs, 2)
    finally:
        host_embed.reset()
    assert tracing.counters() == {"abi.bytes_pageable": 2 * _moved(bufs,
                                                                   False),
                                  "abi.bytes_out": 2 * _out(bufs, False)}
    for got, w in zip(bufs, want):
        _assert_same_bits(got, w)


# ---- the copy plan and the step's lanes, on the CPU --------------------


@pytest.mark.parametrize("iter_yn", [False, True])
def test_copy_plan_holds_every_buffer_once(iter_yn):
    """Each of the eight inputs once, in the ABI's order, first read by
    K1/K2's phase or stage c's; each result once, in phase order, for
    each backend: on "cuda" the two fluxes early (K2's and K3's phases),
    stage c's fields late; on "torch" every result after post_comm."""
    names = [k for k, _ in demo.FIELD_FILES]
    assert [k for k, _ in host_embed.INPUTS] == names
    phases = [PHASE_ORDER.index(p) for _, p in host_embed.INPUTS]
    assert phases == sorted(phases)
    assert {p for _, p in host_embed.INPUTS} == {"pre_comm", "post_comm"}
    assert set(host_embed.RESULTS) == {"cuda", "torch"}
    for backend, early in (("cuda", ["fct_adf_v", "fct_adf_h"]),
                           ("torch", [])):
        results = host_embed.RESULTS[backend][iter_yn]
        assert sorted(k for k, _ in results) == sorted(_outputs(iter_yn))
        assert len({k for k, _ in results}) == len(results)
        phases = [PHASE_ORDER.index(p) for _, p in results]
        assert phases == sorted(phases)
        assert [k for k, p in results if p != "post_comm"] == early


@pytest.mark.parametrize("iter_yn", [False, True])
def test_results_are_final_after_their_phase(toy, iter_yn):
    """Each result the plan writes back before post_comm is a tensor its
    phase returned (K2's factors dict, K3's flux pair), which no later
    phase writes on a whole mesh: the CUDA phases' plain versions, the
    three phases against the whole step's bits."""
    mesh, fields = toy
    cfg = host_embed.config(1, DT_MILLI, 1, int(iter_yn))
    solver = FctAleSolver(mesh, cfg, device="cpu")
    solver._phases = PHASES["cuda"]
    state = solver.init_state(fields)
    pre = solver.pre_comm(state)
    inter = solver.inter_comm(state, pre)
    kept = {"pre_comm": {k: v.clone() for k, v in pre.items()
                         if v is not None},
            "inter_comm": [t.clone() for t in inter if t is not None]}
    out = solver.post_comm(state, pre, inter, (0, mesh.n_nodes))
    whole = FctAleSolver(mesh, cfg, device="cpu")
    whole._step_fn = fct_ale_step_cuda
    want = whole.step(whole.init_state(fields))
    for k, phase in host_embed.RESULTS["cuda"][iter_yn]:
        assert torch.equal(out[k], want[k]), k
        if phase == "pre_comm":
            assert any(out[k] is v for v in pre.values()), k
            assert any(torch.equal(out[k], v)
                       for v in kept[phase].values()), k
        elif phase == "inter_comm":
            assert any(out[k] is t for t in inter), k
            assert any(torch.equal(out[k], t) for t in kept[phase]), k


@pytest.mark.parametrize("where", ["cpu", "backend0"])
def test_serial_sessions_count_no_early_bytes(toy, monkeypatch, where):
    """A solver on the CPU takes no stream: each copy in plan order, in
    turn, every result byte under ``abi.bytes_out``, none early.  Backend
    0 on a (reported) card takes the three streams of every step on the
    card, and its plain stages write no result back before post_comm.
    Either way the buffers are the witness's bit for bit."""
    mesh, _ = toy
    if where == "cpu":
        monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
        tracing.reset_counters()

        def no_stream(*args, **kwargs):
            raise AssertionError("a CPU session made a stream or event")

        monkeypatch.setattr(torch.cuda, "Stream", no_stream)
        monkeypatch.setattr(torch.cuda, "Event", no_stream)
    else:
        card = Card(monkeypatch, FakeCudart())
    bufs = _tracer_buffers(mesh)
    try:
        assert _setup(mesh, 0) == 0
        want = _pageable_steps(host_embed.session().solver, False, bufs, 2)
        Card.steps(bufs, 2)
    finally:
        host_embed.reset()
    c = tracing.counters()
    assert c["abi.bytes_out"] == 2 * _out(bufs, False)
    assert "abi.bytes_out_early" not in c
    if where == "backend0":
        assert card.fake.syncs() == {"compute": 4, "copy": 4, "back": 4}
        assert card.fake.on("copy").count(("record_stream", "compute")) \
            == 4 * len(host_embed.INPUTS)
        assert card.fake.on("back").count(("record_stream", "back")) \
            == 4 * len(_outputs(False))
    for got, w in zip(bufs, want):
        _assert_same_bits(got, w)


@pytest.mark.parametrize("where", ["cpu", "card"])
def test_step_never_calls_the_whole_step(toy, monkeypatch, where):
    """``host_embed.step`` runs the solver's three phases on every device:
    with ``FctAleSolver.step`` raising, steps of backend 0 on the CPU and
    of backend 1 on a (reported) card succeed and give the witness's
    bits."""
    mesh, _ = toy
    if where == "cpu":
        monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
        backend = 0
    else:
        Card(monkeypatch, FakeCudart())
        backend = 1
    bufs = _tracer_buffers(mesh)
    try:
        assert _setup(mesh, backend) == 0
        want = _pageable_steps(host_embed.session().solver, False, bufs, 2)

        def whole_step(self, state):
            raise AssertionError("host_embed.step called FctAleSolver.step")

        monkeypatch.setattr(FctAleSolver, "step", whole_step)
        Card.steps(bufs, 2)
    finally:
        host_embed.reset()
    for got, w in zip(bufs, want):
        _assert_same_bits(got, w)


@pytest.mark.parametrize("backend", [0, 1])
def test_phases_put_every_copy_on_the_current_stream(toy, monkeypatch,
                                                     backend):
    """A rank's ``pre_comm`` and ``post_comm`` (one part, no halo) on a
    (reported) card: no stream made, every copy, cast and phase on the
    current stream in the order copy-in, K1 and K2, the factors out, K3,
    the wait for the factors, then K4-fix, the results out and one
    synchronize; no early byte; two steps give the witness's bits."""
    mesh, _ = toy
    fake = Card(monkeypatch, FakeCudart()).fake
    b = _tracer_buffers(mesh, tracers=1)
    factors = [_own_pages(np.zeros(b[0]["ttf"].shape)) for _ in range(2)]
    ten = [b[0][k].ctypes.data for k, _ in demo.FIELD_FILES] + [
        a.ctypes.data for a in factors]
    en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
    nl = np.ascontiguousarray(mesh.nlev_elem, np.int32)
    xy = np.ascontiguousarray(mesh.node_xy, np.float64)
    try:
        assert host_embed.setup_part(mesh.n_elems, mesh.nl, en.ctypes.data,
                                     nl.ctypes.data, mesh.n_nodes,
                                     mesh.n_nodes, xy.ctypes.data, DT_MILLI,
                                     1, 0, backend) == 0
        want = _pageable_steps(host_embed.session().solver, False, b, 2)
        fake.log.clear()
        for _ in range(2):
            assert host_embed.pre_comm(*ten) == 0
            assert host_embed.post_comm(*ten) == 0
        assert host_embed.session().streams is None
    finally:
        host_embed.reset()
    _assert_same_bits(b[0], want[0])
    assert {e[0] for e in fake.log} == {"compute", "host"}
    step = [e[1:] for e in fake.log[:len(fake.log) // 2]]
    assert [e for e in step if e[0] in ("run", "event_sync", "sync")] == [
        ("run", "pre_comm"), ("run", "inter_comm"), ("event_sync", 1),
        ("run", "post_comm"), ("sync",)]
    c = tracing.counters()
    assert "abi.bytes_out_early" not in c
    assert c["abi.bytes_out"] == 2 * _out(b, False)


@pytest.mark.parametrize("iter_yn", [False, True])
def test_pipelined_step_on_fake_streams(toy, monkeypatch, iter_yn):
    """Backend 1's phases (each kernel wrapper's plain version) on a
    (reported) card, every buffer page-locked, streams and events faked:
    the copy stream takes every input in plan order, each behind an event;
    the current stream casts a phase's inputs after their events, runs the
    phase, records its event; the write-back stream takes each result
    behind its phase's event; every stream is waited for; the counters
    hold every result, the two fluxes early; and three steps of two
    tracers give the serial witness's bits."""
    mesh, _ = toy
    fake = Card(monkeypatch, FakeCudart()).fake
    bufs = _tracer_buffers(mesh)
    try:
        assert _setup(mesh, 1, iter_yn) == 0
        want = _pageable_steps(host_embed.session().solver, iter_yn, bufs, 3)
        fake.log.clear()
        fake.events = 0
        Card.steps(bufs[:1], 1)
        one = list(fake.log)
        Card.steps(bufs[1:], 1)
        Card.steps(bufs, 2)
    finally:
        host_embed.reset()
    for got, w in zip(bufs, want):
        _assert_same_bits(got, w)
    # one step's order: events 1-8 the inputs', 9-11 the phases'
    fake.log = one
    assert fake.on("copy")[:17] == [("wait_stream", "compute")] + [
        e for i in range(1, 9) for e in (("record_stream", "compute"),
                                         ("record", i))]
    inputs = {k: i + 1 for i, (k, _) in enumerate(host_embed.INPUTS)}
    compute = []
    for n, name in enumerate(PHASE_ORDER):
        compute += [("wait", inputs[k]) for k, p in host_embed.INPUTS
                    if p == name]
        compute += [("run", name), ("record", 9 + n)]
    assert fake.on("compute")[:len(compute)] == compute
    back = []
    for k, p in host_embed.RESULTS["cuda"][iter_yn]:
        back += [("wait", 9 + PHASE_ORDER.index(p)),
                 ("record_stream", "back")]
    assert fake.on("back")[:len(back)] == back
    last = {e[0] for e in one[-3:]}
    assert last == {"compute", "copy", "back"} and all(
        e[1] == "sync" for e in one[-3:])
    assert tracing.counters() == {
        "abi.bytes_registered": 3 * _moved(bufs, iter_yn),
        "abi.bytes_out": 3 * _out(bufs, iter_yn), **_early(bufs, 1, 3),
        **_casts(1, 3 * _moved(bufs, iter_yn))}


def test_a_failed_pipelined_step_waits_for_its_streams(toy, monkeypatch,
                                                       capsys):
    """A phase that raises: ``step`` returns 1 after it has waited for
    the copy, current and write-back streams, so no copy in flight
    touches a buffer after the call."""
    mesh, _ = toy
    fake = Card(monkeypatch, FakeCudart(), fail="inter_comm").fake
    b = _tracer_buffers(mesh, tracers=1)
    try:
        assert _setup(mesh, 1) == 0
        assert host_embed.step(*(b[0][k].ctypes.data
                                 for k, _ in demo.FIELD_FILES)) == 1
    finally:
        host_embed.reset()
    assert "inter_comm failed" in capsys.readouterr().err
    runs = [e[2] for e in fake.log if e[1] == "run"]
    assert runs == ["pre_comm", "inter_comm"]
    assert fake.log[-3:] == [("compute", "sync"), ("copy", "sync"),
                             ("back", "sync")]
    assert fake.on("back") == [("sync",)]
