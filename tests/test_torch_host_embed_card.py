"""PyTorch port: the host ABI's DMA of the caller's f64 buffers, on the
card (``host_embed.copy_in`` / ``copy_out``).

Marked ``card``: each test skips where there is no CUDA device.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
neither, without the suite's ``conftest.py``::

    python -m pytest --noconftest tests/test_torch_host_embed_card.py

* on the ``toy`` mesh and at core2 width, backends 1, 0 and 2,
  ``iter_yn`` both ways: after two steps the caller's eight buffers are
  bit for bit those of the pageable path (the cast on the host,
  ``.cpu()``, numpy's write, kept here as the witness) from the same
  inputs, every byte went by DMA of registered memory, backend 1 cast
  every byte on the card and backends 0 and 2 none (``abi.bytes_cast``),
  and ``reset`` unregistered every buffer;
* a buffer the caller had page-locked itself: CUDA refuses the session's
  registration, the CUDA runtime's error is cleared, the buffer is copied
  from and to pageable memory and the buffers are still the witness's bit
  for bit;
* two buffers that share a page: CUDA locks the page for each, and the
  buffers are the witness's bit for bit;
* the contract's end: after ``reset`` the host frees its buffers and
  allocates new ones at the same addresses, and a new session's steps on
  them are the witness's bit for bit;
* the step on its three streams (backend 1, every buffer page-locked), on
  the ``toy`` mesh and at core2 width, ``iter_yn`` both ways: after three
  steps the caller's buffers are bit for bit those of the serial order
  (``FctAleSolver.step`` on the f64 inputs cast on the card, its results
  cast back there), each step counts the two fluxes' bytes early and
  every result's written back, and ``abi.bytes_registered`` and
  ``abi.bytes_cast`` grow by the eight buffers in and the results out; a
  buffer read as soon as
  ``step`` returns is the one read after a ``torch.cuda.synchronize()``;
* a rank's phases, backends 1, 0 and 2: on one part with no halo at
  core2 width, ``pre_comm`` then ``post_comm`` give the buffers of
  ``step`` bit for bit, every factor column written; 2 stripes of core2
  in two processes on the card (``tests/phases_ranks.py``, gloo) match
  the plain whole-mesh reference ``portbench/reference/fct.py`` after 1
  and 3 steps, at the ABI cell's limit 2e-4 (backend 1) and at 1e-12
  (backends 0 and 2), and do not with the exchange skipped;
* backend 2, the kernels in float64, within 1e-12 of backend 0 at core2
  width after three calls, by ``step`` and by ``pre_comm`` /
  ``post_comm`` on one part, ``iter_yn`` both ways.
"""

import mmap

import numpy as np
import pytest
import torch

import phases_ranks
from fesom2_accelerate_tpu_torch import host_embed
from fesom2_accelerate_tpu_torch.mesh import (
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.native import demo
from fesom2_accelerate_tpu_torch.runtime import tracing
from portbench.reference import fct
from portbench.reference.compare import relerr

pytestmark = pytest.mark.card

PAGE = mmap.PAGESIZE
DT_MILLI = 500
STEPS = 2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.cuda.get_device_name(0)


@pytest.fixture(scope="module")
def meshes(card):
    return {}


def _mesh(meshes: dict, preset: str):
    if preset not in meshes:
        meshes[preset] = generate_planar_mesh(preset=preset)
    return meshes[preset]


def _own_pages(a: np.ndarray) -> np.ndarray:
    """A copy of ``a`` on pages of its own, as a large host array's are
    (the ``toy`` mesh's fields are a few hundred bytes)."""
    raw = np.empty(-(-a.nbytes // PAGE) * PAGE + PAGE, np.uint8)
    off = -raw.ctypes.data % PAGE
    out = raw[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def _setup(mesh, backend: int, iter_yn: bool) -> None:
    en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
    nl = np.ascontiguousarray(mesh.nlev_elem, np.int32)
    xy = np.ascontiguousarray(mesh.node_xy, np.float64)
    assert host_embed.setup(mesh.n_elems, mesh.nl, en.ctypes.data,
                            nl.ctypes.data, mesh.n_nodes, xy.ctypes.data,
                            DT_MILLI, 1, int(iter_yn), backend) == 0


def _outputs(iter_yn: bool) -> list:
    return ["fct_adf_v", "fct_adf_h"] + (
        ["fct_LO"] if iter_yn else ["del_ttf_advvert", "del_ttf_advhoriz"])


def _steps(bufs: dict) -> None:
    for _ in range(STEPS):
        assert host_embed.step(*(bufs[k].ctypes.data
                                 for k, _ in demo.FIELD_FILES)) == 0


def _pageable_steps(solver, iter_yn: bool, bufs: dict) -> dict:
    """Copies of ``bufs`` after STEPS steps of the pageable path, the
    parent's ``copy_in`` / ``copy_out``: ``FctAleSolver.init_state`` (the
    cast on the host), the step, ``.cpu()`` and numpy's write."""
    got = {k: v.copy() for k, v in bufs.items()}
    for _ in range(STEPS):
        out = solver.step(solver.init_state(got))
        for k in _outputs(iter_yn):
            np.copyto(got[k], out[k].cpu().numpy())
    return got


def _early(bufs: dict) -> int:
    """The bytes of the results a backend-1 step writes back early: the
    limited (or residual) fluxes."""
    return bufs["fct_adf_v"].nbytes + bufs["fct_adf_h"].nbytes


def _assert_same_bits(got: dict, want: dict) -> None:
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].view(np.uint64),
                                      v.view(np.uint64), err_msg=k)


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("backend", [1, 0, 2])
@pytest.mark.parametrize("preset", ["toy", "core2"])
def test_buffers_bit_identical_to_the_pageable_path(card, meshes, preset,
                                                    backend, iter_yn):
    mesh = _mesh(meshes, preset)
    fields = random_fields(mesh, seed=11, dtype=np.float64)
    bufs = {k: _own_pages(np.asarray(fields[k], np.float64))
            for k, _ in demo.FIELD_FILES}
    tracing.reset_counters()
    try:
        _setup(mesh, backend, iter_yn)
        want = _pageable_steps(host_embed.session().solver, iter_yn, bufs)
        tracing.reset_counters()
        _steps(bufs)
        held = dict(host_embed.session().pins.held)
    finally:
        host_embed.reset()
    assert held == {v.ctypes.data: v.nbytes for v in bufs.values()}
    out = sum(bufs[k].nbytes for k in _outputs(iter_yn))
    moved = sum(v.nbytes for v in bufs.values()) + out
    early = {"abi.bytes_out_early": STEPS * _early(bufs)} if backend else {}
    cast = {"abi.bytes_cast": STEPS * moved} if backend == 1 else {}
    assert tracing.counters() == {"abi.bytes_registered": STEPS * moved,
                                  "abi.bytes_out": STEPS * out, **early,
                                  **cast}
    _assert_same_bits(bufs, want)
    # reset unregistered them: each registers again, and is released
    cudart = torch.cuda.cudart()
    for addr, n in held.items():
        assert int(cudart.cudaHostRegister(addr, n, 0)) == 0
        assert int(cudart.cudaHostUnregister(addr)) == 0


def test_a_refused_registration_on_the_card(card, meshes):
    """``ttf`` page-locked by the caller: the session's registration fails
    (CUDA's "already registered"), its error does not reach the next
    launch, and ``ttf`` takes the pageable path."""
    mesh = _mesh(meshes, "toy")
    fields = random_fields(mesh, seed=12, dtype=np.float64)
    bufs = {k: _own_pages(np.asarray(fields[k], np.float64))
            for k, _ in demo.FIELD_FILES}
    ttf = bufs["ttf"]
    cudart = torch.cuda.cudart()
    assert int(cudart.cudaHostRegister(ttf.ctypes.data, ttf.nbytes, 0)) == 0
    try:
        _setup(mesh, 1, False)
        want = _pageable_steps(host_embed.session().solver, False, bufs)
        tracing.reset_counters()
        _steps(bufs)
        torch.cuda.synchronize()
        refused = dict(host_embed.session().pins.refused)
    finally:
        host_embed.reset()
        assert int(cudart.cudaHostUnregister(ttf.ctypes.data)) == 0
    assert refused == {ttf.ctypes.data: ttf.nbytes}
    assert tracing.counters()["abi.bytes_pageable"] == STEPS * ttf.nbytes
    _assert_same_bits(bufs, want)


def test_a_shared_page_on_the_card(card, meshes):
    """``ttf`` and ``fct_LO`` end to end on one page (the ``toy`` mesh's
    fields are a few hundred bytes): CUDA locks the shared page for each,
    both go by DMA, the buffers are the witness's bit for bit, and after
    ``reset`` each registers again and is released."""
    mesh = _mesh(meshes, "toy")
    fields = random_fields(mesh, seed=13, dtype=np.float64)
    bufs = {k: _own_pages(np.asarray(fields[k], np.float64))
            for k, _ in demo.FIELD_FILES}
    n = bufs["ttf"].size
    assert bufs["ttf"].nbytes % PAGE
    pair = _own_pages(np.concatenate([bufs["ttf"].ravel(),
                                      bufs["fct_LO"].ravel()]))
    bufs["ttf"] = pair[:n].reshape(bufs["ttf"].shape)
    bufs["fct_LO"] = pair[n:].reshape(bufs["fct_LO"].shape)
    try:
        _setup(mesh, 1, False)
        want = _pageable_steps(host_embed.session().solver, False, bufs)
        tracing.reset_counters()
        _steps(bufs)
        held = dict(host_embed.session().pins.held)
    finally:
        host_embed.reset()
    assert held == {v.ctypes.data: v.nbytes for v in bufs.values()}
    assert "abi.bytes_pageable" not in tracing.counters()
    _assert_same_bits(bufs, want)
    cudart = torch.cuda.cudart()
    for addr, n in held.items():
        assert int(cudart.cudaHostRegister(addr, n, 0)) == 0
        assert int(cudart.cudaHostUnregister(addr)) == 0


def _mapped(a: np.ndarray) -> tuple:
    """A copy of ``a`` in an anonymous mapping of its own, which closing
    unmaps, as the C library frees a large allocation."""
    m = mmap.mmap(-1, -(-a.nbytes // PAGE) * PAGE)
    out = np.frombuffer(m, a.dtype, a.size).reshape(a.shape)
    out[...] = a
    return m, out


def test_freed_after_reset_and_allocated_anew(card, meshes):
    """A session's steps, ``reset``, the buffers unmapped and at once
    mapped anew (where the kernel gives the addresses back, at the same
    ones) and filled with other fields: a new session's steps on them are
    the witness's bit for bit, every byte from and to page-locked memory."""
    mesh = _mesh(meshes, "core2")
    fields = [random_fields(mesh, seed=seed, dtype=np.float64)
              for seed in (14, 15)]
    addrs, unmap = [], []
    for f in fields:
        for m in unmap:
            m.close()
        maps = {k: _mapped(np.asarray(f[k], np.float64))
                for k, _ in demo.FIELD_FILES}
        bufs = {k: a for k, (_, a) in maps.items()}
        addrs.append({a.ctypes.data for a in bufs.values()})
        try:
            _setup(mesh, 1, False)
            want = _pageable_steps(host_embed.session().solver, False, bufs)
            tracing.reset_counters()
            _steps(bufs)
        finally:
            host_embed.reset()
        assert "abi.bytes_pageable" not in tracing.counters()
        _assert_same_bits(bufs, want)
        unmap = [m for m, _ in maps.values()]
        del maps, bufs, want
    for m in unmap:
        m.close()
    print("addresses reused:", len(addrs[0] & addrs[1]), "of", len(addrs[0]))


def _serial_steps(solver, iter_yn: bool, bufs: dict, steps: int) -> dict:
    """Copies of ``bufs`` after ``steps`` steps in the serial order on the
    card: the f64 inputs copied to the card and cast there,
    ``FctAleSolver.step``, its results cast back to f64 there and
    copied back."""
    got = {k: v.copy() for k, v in bufs.items()}
    for _ in range(steps):
        state = {k: torch.from_numpy(v).to(solver.device).to(
            solver.cfg.dtype) for k, v in got.items()}
        out = solver.step(state)
        for k in _outputs(iter_yn):
            np.copyto(got[k], out[k].to(torch.float64).cpu().numpy())
    return got


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("preset", ["toy", "core2"])
def test_pipelined_step_is_the_serial_order(card, meshes, preset, iter_yn):
    mesh = _mesh(meshes, preset)
    fields = random_fields(mesh, seed=17, dtype=np.float64)
    bufs = {k: _own_pages(np.asarray(fields[k], np.float64))
            for k, _ in demo.FIELD_FILES}
    out = sum(bufs[k].nbytes for k in _outputs(iter_yn))
    moved = sum(v.nbytes for v in bufs.values()) + out
    try:
        _setup(mesh, 1, iter_yn)
        want = _serial_steps(host_embed.session().solver, iter_yn, bufs, 3)
        tracing.reset_counters()
        for n in range(1, 4):
            assert host_embed.step(*(bufs[k].ctypes.data
                                     for k, _ in demo.FIELD_FILES)) == 0
            assert host_embed.session().streams is not None
            assert tracing.counters() == {
                "abi.bytes_registered": n * moved, "abi.bytes_out": n * out,
                "abi.bytes_out_early": n * _early(bufs),
                "abi.bytes_cast": n * moved}
    finally:
        host_embed.reset()
    _assert_same_bits(bufs, want)


def test_buffers_whole_when_step_returns(card, meshes):
    """Each buffer read as soon as ``step`` returns is the buffer read
    after a ``torch.cuda.synchronize()``: no copy of the step is still in
    flight."""
    mesh = _mesh(meshes, "core2")
    fields = random_fields(mesh, seed=18, dtype=np.float64)
    bufs = {k: _own_pages(np.asarray(fields[k], np.float64))
            for k, _ in demo.FIELD_FILES}
    try:
        _setup(mesh, 1, False)
        for _ in range(STEPS):
            assert host_embed.step(*(bufs[k].ctypes.data
                                     for k, _ in demo.FIELD_FILES)) == 0
            at_return = {k: v.copy() for k, v in bufs.items()}
            torch.cuda.synchronize()
            _assert_same_bits(at_return, bufs)
        assert host_embed.session().streams is not None
    finally:
        host_embed.reset()


@pytest.mark.parametrize("backend", [1, 0, 2])
def test_phases_on_one_part_are_the_step(card, meshes, backend):
    mesh = _mesh(meshes, "core2")
    fields = random_fields(mesh, seed=16, dtype=np.float64)
    by_step, by_phases = ({k: _own_pages(np.asarray(fields[k], np.float64))
                           for k, _ in demo.FIELD_FILES} for _ in range(2))
    factors = [_own_pages(np.zeros(by_step["ttf"].shape)) for _ in range(2)]
    en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
    nl = np.ascontiguousarray(mesh.nlev_elem, np.int32)
    xy = np.ascontiguousarray(mesh.node_xy, np.float64)
    ten = [by_phases[k].ctypes.data for k, _ in demo.FIELD_FILES] + [
        a.ctypes.data for a in factors]
    try:
        assert host_embed.setup_part(mesh.n_elems, mesh.nl, en.ctypes.data,
                                     nl.ctypes.data, mesh.n_nodes,
                                     mesh.n_nodes, xy.ctypes.data, DT_MILLI,
                                     1, 0, backend) == 0
        for _ in range(STEPS):
            assert host_embed.step(*(by_step[k].ctypes.data
                                     for k, _ in demo.FIELD_FILES)) == 0
            assert host_embed.pre_comm(*ten) == 0
            assert host_embed.post_comm(*ten) == 0
    finally:
        host_embed.reset()
    _assert_same_bits(by_phases, by_step)
    assert all(np.abs(a).max() > 0 for a in factors)


# the whole-mesh reference's limits: the ABI cell's (f32 kernels), f64's
PART_LIMITS = {1: 2e-4, 0: 1e-12, 2: 1e-12}
CORE2 = (420, 303, 48)  # the configuration's planar mesh: nx, ny, nl


@pytest.mark.parametrize("backend", [1, 0, 2])
def test_two_parts_in_two_processes_match_the_reference(card, tmp_path,
                                                        backend):
    steps = [1, 3]
    status, logs = phases_ranks.launch(2, tmp_path / "out.npz", CORE2,
                                       backend, steps, "cuda", 600.0)
    assert status == 0, "\n".join(f"rank {r}:\n{log[-3000:]}"
                                  for r, log in enumerate(logs))
    with np.load(tmp_path / "out.npz") as z:
        saved = {k: z[k] for k in z.files}
    _, ref, fields = phases_ranks.case(CORE2)
    mk = fct.Masks(ref, torch.float64, "cuda")
    f = {k: torch.as_tensor(v, device="cuda") for k, v in fields.items()}
    eps = host_embed.config(backend, DT_MILLI, 1, 0).flux_eps
    for s in range(1, max(steps) + 1):
        f.update(fct.step(mk, f, dt=DT_MILLI * 1e-3, flux_eps=eps))
        if s not in steps:
            continue
        want = {k: f[k] for k in phases_ranks.WRITTEN}
        for exchanged in (True, False):
            got = {k: saved[phases_ranks.key(exchanged, s, k)]
                   for k in phases_ranks.WRITTEN}
            err = relerr(got, want)
            print(f"backend {backend}, step {s}, exchanged {exchanged}: "
                  f"relerr {err:.3e}")
            assert (err <= PART_LIMITS[backend]) == exchanged, err


def _three_calls(mesh, fields: dict, backend: int, iter_yn: bool,
                 phases: bool) -> dict:
    """The caller's buffers after three calls of ``backend`` on a session
    of one part with no halo: ``step``, or ``pre_comm`` then
    ``post_comm``."""
    bufs = {k: _own_pages(np.asarray(fields[k], np.float64))
            for k, _ in demo.FIELD_FILES}
    factors = [_own_pages(np.zeros(bufs["ttf"].shape)) for _ in range(2)]
    en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
    nl = np.ascontiguousarray(mesh.nlev_elem, np.int32)
    xy = np.ascontiguousarray(mesh.node_xy, np.float64)
    ten = [bufs[k].ctypes.data for k, _ in demo.FIELD_FILES] + [
        a.ctypes.data for a in factors]
    try:
        assert host_embed.setup_part(mesh.n_elems, mesh.nl, en.ctypes.data,
                                     nl.ctypes.data, mesh.n_nodes,
                                     mesh.n_nodes, xy.ctypes.data, DT_MILLI,
                                     1, int(iter_yn), backend) == 0
        for _ in range(3):
            if phases:
                assert host_embed.pre_comm(*ten) == 0
                assert host_embed.post_comm(*ten) == 0
            else:
                assert host_embed.step(*ten[:8]) == 0
    finally:
        host_embed.reset()
    return {k: torch.from_numpy(bufs[k]) for k in _outputs(iter_yn)}


@pytest.mark.parametrize("phases", [False, True], ids=["step", "phases"])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_backend2_is_backend0_in_float64(card, meshes, iter_yn, phases):
    mesh = _mesh(meshes, "core2")
    fields = random_fields(mesh, seed=19, dtype=np.float64)
    tracing.reset_counters()
    got = _three_calls(mesh, fields, 2, iter_yn, phases)
    assert "abi.bytes_cast" not in tracing.counters()
    want = _three_calls(mesh, fields, 0, iter_yn, phases)
    err = relerr(got, want)
    print(f"backend 2 vs 0, iter_yn {iter_yn}, phases {phases}: relerr "
          f"{err:.3e}")
    assert err <= PART_LIMITS[2], err
