"""PyTorch port: the host ABI's backend 2, the CUDA kernels in float64
(``host_embed.config(2, ...)``: FESOM2's own working precision, as the
reference library builds on ``real_type = double``), on the CPU:

* each backend's config (dtype, ``flux_eps``), and any other backend
  number refused, naming 0, 1 and 2, from Python and through the C host;
* backends 1 and 2 without a card, or asked for the CPU, fail
  ``f2t_setup_`` with istat 1: nothing falls back;
* backend 2 through ``host_embed.step``, its solver a CPU one given the
  CUDA phases (each kernel wrapper's plain version, in float64), within
  1e-12 of backend 0 over 3 calls in a row whose outputs are fed back,
  the buffers bit for bit the witness's that steps ``FctAleSolver``
  itself; on a (reported) card with streams and events faked, each phase
  reads the tensors the DMA landed in (no cast, no second copy), each
  call waits for its three streams before the next one's copies start;
* backend 2 through ``pre_comm``, the host's exchange of the factors'
  halo columns and ``post_comm`` on the two parts of a small mesh (both
  sessions in one process) within 1e-12 of backend 0 on the same parts
  and of the plain whole-mesh reference;
* the counter ``abi.bytes_cast``: every byte of the ABI's traffic under
  backend 1, none under backends 0 and 2, by ``step`` and by the phases.
"""

import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu_torch import host_embed
from fesom2_accelerate_tpu_torch.model import FctAleSolver
from fesom2_accelerate_tpu_torch.model.fct_ale import PHASES
from fesom2_accelerate_tpu_torch.native import build, demo
from fesom2_accelerate_tpu_torch.ops.cuda.step import fct_ale_step_cuda
from fesom2_accelerate_tpu_torch.runtime import tracing

from portbench import inputs, ranks
from portbench.reference import fct
from portbench.reference.compare import relerr
from portbench.reference.mesh import build_mesh
from test_torch_host_embed import (
    DT_MILLI,
    Card,
    FakeCudart,
    _assert_same_bits,
    _outputs,
    _pageable_steps,
    _setup,
    _tracer_buffers,
)

F64_RELERR = 1e-12
MESH = (16, 12, 10)  # nx, ny, nl of the two-part case
SEED = 2 ** 31 + 19


@pytest.fixture(scope="module")
def toy():
    from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh

    return generate_planar_mesh(preset="toy")


@pytest.fixture(scope="module")
def demo_exe():
    if not build.available():
        pytest.skip("host embedding shim unavailable (no g++ or libpython)")
    return build.build()[1]


@pytest.mark.parametrize("backend, dtype, eps", [
    (0, torch.float64, 1e-16), (1, torch.float32, 1e-7),
    (2, torch.float64, 1e-16)])
def test_config_of_each_backend(backend, dtype, eps):
    cfg = host_embed.config(backend, DT_MILLI, 2, 1)
    assert (cfg.dtype, cfg.flux_eps) == (dtype, eps)
    assert (cfg.dt, cfg.vlimit, cfg.iter_yn) == (0.5, 2, True)


@pytest.mark.parametrize("backend", [3, -1])
def test_other_backends_raise_naming_the_three(toy, capsys, backend):
    with pytest.raises(ValueError, match=r"0 \(.*1 \(CUDA kernels f32\) "
                                         r"or 2 \(CUDA kernels f64\)"):
        host_embed.config(backend, DT_MILLI, 1, 0)
    assert _setup(toy, backend) == 1
    assert "or 2 (CUDA kernels f64)" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="setup has not succeeded"):
        host_embed.dims()


@pytest.mark.parametrize("backend", [1, 2, 3])
def test_f2t_setup_without_a_card(tmp_path, toy, demo_exe, backend):
    """Through the C host, the card hidden: istat 1 from ``f2t_setup_``
    (the demo exits 4), the kernels' backends for want of a card, any
    other number for its own sake."""
    from fesom2_accelerate_tpu_torch.mesh import random_fields

    demo.write_inputs(tmp_path, toy, random_fields(toy, seed=5), DT_MILLI,
                      1, False, backend)
    p = demo.run(demo_exe, tmp_path, env={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 4, p.stdout + p.stderr
    if backend == 3:
        assert "or 2 (CUDA kernels f64), got 3" in p.stderr
    else:
        assert (f"backend {backend} runs the CUDA kernels and needs a CUDA "
                f"device") in p.stderr


@pytest.mark.parametrize("backend", [1, 2])
def test_kernel_backends_asked_for_the_cpu_fail_setup(toy, capsys,
                                                      monkeypatch, backend):
    monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _setup(toy, backend) == 1
    err = capsys.readouterr().err
    assert f"backend {backend} runs the CUDA kernels" in err
    assert f"{host_embed.DEVICE_ENV}=cpu" in err


def _cuda_phases(mesh, cfg, backend):
    """``host_embed._solver`` on the CPU: backend 0 the plain stages, the
    kernels' backends the CUDA phases, each wrapper's plain version."""
    solver = FctAleSolver(mesh, cfg, "torch", device="cpu")
    if backend != 0:
        solver._step_fn = fct_ale_step_cuda
        solver._phases = PHASES["cuda"]
        solver.backend = "cuda"
    return solver


def _abi_steps(mesh, backend: int, iter_yn: bool, steps: int) -> tuple:
    """Two tracers' buffers after ``steps`` calls of ``host_embed.step``
    each, the outputs of one call the inputs of the next, and a witness
    that steps the session's solver on host-cast copies."""
    bufs = _tracer_buffers(mesh)
    try:
        assert _setup(mesh, backend, iter_yn) == 0
        want = _pageable_steps(host_embed.session().solver, iter_yn, bufs,
                               steps)
        for _ in range(steps):
            for b in bufs:
                assert host_embed.step(*(b[k].ctypes.data
                                         for k, _ in demo.FIELD_FILES)) == 0
    finally:
        host_embed.reset()
    return bufs, want


@pytest.mark.parametrize("iter_yn", [False, True])
def test_backend2_steps_are_backend0s(toy, monkeypatch, iter_yn):
    monkeypatch.setattr(host_embed, "_solver", _cuda_phases)
    tracing.reset_counters()
    got, witness = _abi_steps(toy, 2, iter_yn, 3)
    assert "abi.bytes_cast" not in tracing.counters()
    want, _ = _abi_steps(toy, 0, iter_yn, 3)
    for g, w, b in zip(got, want, witness):
        _assert_same_bits(g, b)
        keys = _outputs(iter_yn)
        assert relerr({k: g[k] for k in keys},
                      {k: torch.from_numpy(w[k]) for k in keys}) \
            <= F64_RELERR


def test_backend2_phases_read_the_dma_targets(toy, monkeypatch):
    """On a (reported) card, streams and events faked: the tensors each
    phase is given are those ``copy_in`` staged (the DMA's targets, no cast
    and no second copy), the copy stream waits for the compute stream
    before a call's first copy, and a call waits for its three streams
    before the next call starts; the buffers are the witness's bit for
    bit."""
    card = Card(monkeypatch, FakeCudart())
    staged, seen = [], []
    copy_in = host_embed.copy_in

    def recorded(host):
        out = copy_in(host)
        staged.append({k: t for k, (t, _) in out.items()})
        return out

    monkeypatch.setattr(host_embed, "copy_in", recorded)
    bufs = _tracer_buffers(toy)
    try:
        assert _setup(toy, 2) == 0
        solver = host_embed.session().solver
        assert solver.cfg.dtype == torch.float64 and solver.backend == "cuda"
        want = _pageable_steps(solver, False, bufs, 2)
        for name in ("pre_comm", "post_comm"):
            run = getattr(solver, name)

            def phase(state, *args, run=run):
                seen.append({k: v for k, v in state.items()})
                return run(state, *args)

            monkeypatch.setattr(solver, name, phase)
        card.fake.log.clear()
        card.steps(bufs, 2)
    finally:
        host_embed.reset()
    for got, w in zip(bufs, want):
        _assert_same_bits(got, w)
    assert len(staged) == 4 and len(seen) == 8
    for n, dma in enumerate(staged):
        state = seen[2 * n + 1]  # post_comm's: every input by then
        assert set(state) == set(dma)
        assert all(state[k] is t and t.dtype == torch.float64
                   for k, t in dma.items())
    calls = []
    for e in card.fake.log:
        if e[0] == "copy" and e[1] == "wait_stream":
            calls.append([])
        calls[-1].append(e)
    assert len(calls) == 4
    for c in calls:
        assert c[0] == ("copy", "wait_stream", "compute")
        assert {e[0] for e in c[-3:]} == {"compute", "copy", "back"}
        assert all(e[1] == "sync" for e in c[-3:])
    assert "abi.bytes_cast" not in tracing.counters()


@pytest.mark.parametrize("backend", [0, 1, 2])
def test_bytes_cast_counts_the_casts(toy, monkeypatch, backend):
    """``abi.bytes_cast`` after two steps of two tracers on a (reported)
    card: the ABI's every byte, in and out, under backend 1, which casts
    between the host's f64 and f32; nothing under backends 0 and 2."""
    Card(monkeypatch, FakeCudart())
    bufs = _tracer_buffers(toy)
    try:
        assert _setup(toy, backend) == 0
        Card.steps(bufs, 2)
    finally:
        host_embed.reset()
    c = tracing.counters()
    moved = c["abi.bytes_registered"] + c.get("abi.bytes_pageable", 0)
    assert c.get("abi.bytes_cast", 0) == (moved if backend == 1 else 0)
    assert moved == 2 * sum(
        sum(b[k].nbytes for k, _ in demo.FIELD_FILES)
        + sum(b[k].nbytes for k in _outputs(False)) for b in bufs)


# ---- two parts through the phases, in one process ----------------------


@pytest.fixture(scope="module")
def parts():
    """The two stripes of the planar mesh MESH, its reference mesh and one
    tracer's seeded f64 fields."""
    nx, ny, nl = MESH
    raw = inputs.planar_mesh(nx, ny, nl)
    ref = build_mesh(raw[0], raw[1], nl, raw[2])
    made = inputs.fields(ref, SEED, 1, "cpu")[0]
    fields = {k: (v[0] if k in inputs.TRACER_FIELDS else v).numpy()
              for k, v in made.items()}
    return ranks.stripes(*raw, ref.edges, ranks.even_counts(ref.n_nodes,
                                                            2)), ref, fields


def _exchange(ps: list, factors: list) -> None:
    """The hosts' ``exchange_nod`` of both factors, each halo column
    overwritten with its owner's value (``ranks.exchange`` without MPI)."""
    for q in ps:
        for r, cols in q.recvs.items():
            src = ps[r].sends[q.rank]
            for mine, theirs in zip(factors[q.rank], factors[r]):
                mine[:, cols] = theirs[:, src]


def _two_parts(parts, backend: int, steps: int) -> dict:
    """The owned columns and edges of the written fields, as whole-mesh
    arrays, after ``steps`` steps of both parts, each its own session of
    ``setup_part`` (the module's one session swapped between them)."""
    ps, ref, fields = parts
    sessions, bufs, factors, addrs = [], [], [], []
    try:
        for p in ps:
            assert host_embed.setup_part(
                len(p.elem_nodes), MESH[2], p.elem_nodes.ctypes.data,
                p.nlev_elem.ctypes.data, len(p.nodes), p.n_owned,
                p.node_xy.ctypes.data, DT_MILLI, 1, 0, backend) == 0
            sessions.append(host_embed._SESSION)
            host_embed._SESSION = None
            b = {k: np.ascontiguousarray(
                v[:, p.edges] * p.edge_sign if k == "fct_adf_h"
                else v[:, p.nodes]) for k, v in fields.items()}
            f = [np.zeros((ref.n_layers, len(p.nodes))) for _ in range(2)]
            bufs.append(b)
            factors.append(f)
            addrs.append([b[k].ctypes.data for k, _ in demo.FIELD_FILES]
                         + [a.ctypes.data for a in f])
        for _ in range(steps):
            for s, a in zip(sessions, addrs):
                host_embed._SESSION = s
                assert host_embed.pre_comm(*a) == 0
            _exchange(ps, factors)
            for s, a in zip(sessions, addrs):
                host_embed._SESSION = s
                assert host_embed.post_comm(*a) == 0
    finally:
        host_embed._SESSION = None
        for s in sessions:
            host_embed._SESSION = s
            host_embed.reset()
    whole = {}
    for k in ("fct_adf_v", "fct_adf_h", "del_ttf_advvert",
              "del_ttf_advhoriz"):
        w = np.zeros(fields[k].shape)
        for p, b in zip(ps, bufs):
            if k == "fct_adf_h":
                own = p.owned_edges
                w[:, p.edges[own]] = b[k][:, own] * p.edge_sign[own]
            else:
                w[:, p.nodes[:p.n_owned]] = b[k][:, :p.n_owned]
        whole[k] = torch.from_numpy(w)
    return whole


@pytest.mark.parametrize("steps", [1, 3])
def test_backend2_phases_on_two_parts(parts, monkeypatch, steps):
    monkeypatch.setattr(host_embed, "_solver", _cuda_phases)
    monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
    tracing.reset_counters()
    got = _two_parts(parts, 2, steps)
    c = tracing.counters()
    assert "abi.bytes_cast" not in c and c["abi.bytes_pageable"] > 0
    want = _two_parts(parts, 0, steps)
    assert relerr(got, want) <= F64_RELERR
    _, ref, fields = parts
    mk = fct.Masks(ref, torch.float64, "cpu")
    f = {k: torch.as_tensor(v) for k, v in fields.items()}
    for _ in range(steps):
        f.update(fct.step(mk, f, dt=DT_MILLI * 1e-3, flux_eps=1e-16))
    assert relerr(got, {k: f[k] for k in got}) <= F64_RELERR


def test_bytes_cast_of_the_phases(parts, monkeypatch):
    """Backend 1's phases cast every byte they move, the factors' too;
    backend 2's none."""
    monkeypatch.setattr(host_embed, "_solver", _cuda_phases)
    monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
    for backend in (1, 2):
        tracing.reset_counters()
        _two_parts(parts, backend, 1)
        c = tracing.counters()
        moved = c.get("abi.bytes_registered", 0) + c["abi.bytes_pageable"]
        assert c.get("abi.bytes_cast", 0) == (moved if backend == 1 else 0)
