"""PyTorch port: a FESOM2 rank's partition through the host ABI's phases
(``host_embed.setup_part``, ``pre_comm``, the host's exchange of the
factors' halo columns, ``post_comm``) on the CPU, backend 0 in float64
(``FESOM2_TORCH_DEVICE=cpu``), held against the plain whole-mesh
reference ``portbench/reference/fct.py``:

* 2 and 4 stripes of a small planar mesh, each rank a process over gloo
  (``tests/phases_ranks.py``; every launch has its own timeout, which
  kills every rank): the owned columns and edges gathered after 1 and 3
  steps equal the reference's at 1e-12; with the exchange skipped they do
  not, by more than 1e-6;
* one part with no halo: ``host_embed.step``, and ``pre_comm`` then
  ``post_comm``, give the buffers of ``FctAleSolver.step`` on the same
  inputs bit for bit, ``iter_yn`` both ways;
* the halo rows of the part's mesh emptied, the others kept
  (``host_embed.part_mesh``), and ``n_owned`` outside 1..N refused;
* the contract: ``post_comm`` with no ``pre_comm`` before it or on other
  buffers, a second ``pre_comm`` before its ``post_comm``, and ``step``
  on a partition with a halo each return 1 and say why.

The file imports neither JAX nor the JAX package."""

import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu_torch import host_embed
from fesom2_accelerate_tpu_torch.mesh.topology import (
    build_mesh_from_elements,
)
from fesom2_accelerate_tpu_torch.native import demo

from portbench import ranks
from portbench.reference import fct
from portbench.reference.compare import relerr

import phases_ranks

MESH = (16, 12, 10)  # nx, ny, nl: 192 nodes, 12 a lattice column
STEPS = [1, 3]
TIMEOUT = 180.0  # seconds a launch may take before every rank is killed
F64_RELERR = 1e-12


@pytest.fixture(scope="module")
def case():
    return phases_ranks.case(MESH)


@pytest.fixture(scope="module")
def reference(case):
    """The plain reference's fields after each of STEPS steps."""
    _, ref, fields = case
    mk = fct.Masks(ref, torch.float64, "cpu")
    f = {k: torch.as_tensor(v) for k, v in fields.items()}
    out = {}
    for s in range(1, max(STEPS) + 1):
        f.update(fct.step(mk, f, dt=phases_ranks.DT_MILLI * 1e-3,
                          flux_eps=host_embed.config(0, 500, 1, 0).flux_eps))
        out[s] = {k: f[k].clone() for k in phases_ranks.WRITTEN}
    return out


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """world -> the arrays rank 0 saved, one launch a world."""
    runs = {}

    def get(world):
        if world not in runs:
            out = tmp_path_factory.mktemp(f"ranks{world}") / "out.npz"
            status, logs = phases_ranks.launch(world, out, MESH, 0, STEPS,
                                               "cpu", TIMEOUT)
            assert status == 0, "\n".join(
                f"rank {r}:\n{log[-3000:]}" for r, log in enumerate(logs))
            with np.load(out) as z:
                runs[world] = {k: z[k] for k in z.files}
        return runs[world]
    return get


@pytest.mark.parametrize("exchanged", [True, False],
                         ids=["exchanged", "skipped"])
@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("world", [2, 4])
def test_partition_against_the_whole_mesh_reference(ran, reference, world,
                                                    steps, exchanged):
    saved = ran(world)
    got = {k: saved[phases_ranks.key(exchanged, steps, k)]
           for k in phases_ranks.WRITTEN}
    err = relerr(got, reference[steps])
    if exchanged:
        assert err <= F64_RELERR, f"relerr {err:.3e}"
    else:
        assert err > 1e-6, f"relerr {err:.3e} without the exchange"


def _setup(raw, nl: int, n_owned: int, iter_yn: bool = False) -> int:
    elem_nodes, nlev_elem, node_xy = raw
    return host_embed.setup_part(
        len(elem_nodes), nl, elem_nodes.ctypes.data, nlev_elem.ctypes.data,
        len(node_xy), n_owned, node_xy.ctypes.data, phases_ranks.DT_MILLI,
        1, int(iter_yn), 0)


def _buffers(fields: dict) -> tuple:
    """The eight f64 buffers of a step and the two factor buffers, fresh,
    and their ten addresses."""
    bufs = {k: np.array(fields[k], np.float64) for k, _ in demo.FIELD_FILES}
    shape = fields["ttf"].shape
    factors = [np.zeros(shape), np.zeros(shape)]
    return bufs, factors, [bufs[k].ctypes.data for k, _ in demo.FIELD_FILES
                           ] + [a.ctypes.data for a in factors]


@pytest.mark.parametrize("iter_yn", [False, True])
def test_one_part_phases_are_the_step_bit_for_bit(case, monkeypatch,
                                                  iter_yn):
    raw, ref, fields = case
    monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
    by_step, step_factors, addrs = _buffers(fields)
    by_phases, factors, paddrs = _buffers(fields)
    want = {k: v.copy() for k, v in by_step.items()}
    try:
        assert _setup(raw, MESH[2], ref.n_nodes, iter_yn) == 0
        solver = host_embed.session().solver
        for _ in range(2):
            out = solver.step(solver.init_state(want))
            for k, _ in host_embed.RESULTS["torch"][iter_yn]:
                np.copyto(want[k], out[k].numpy())
            assert host_embed.step(*addrs[:8]) == 0
            assert host_embed.pre_comm(*paddrs) == 0
            assert host_embed.post_comm(*paddrs) == 0
    finally:
        host_embed.reset()
    for k, v in want.items():
        for got in (by_step, by_phases):
            np.testing.assert_array_equal(got[k].view(np.uint64),
                                          v.view(np.uint64), err_msg=k)
    # the factors of every column reached the host
    assert np.abs(factors[0]).max() > 0 and np.abs(factors[1]).max() > 0


def test_part_mesh_empties_the_halo_rows(case):
    (elem_nodes, nlev_elem, node_xy), ref, _ = case
    p = ranks.stripes(elem_nodes, nlev_elem, node_xy, ref.edges,
                      ranks.even_counts(ref.n_nodes, 2))[1]
    whole = build_mesh_from_elements(p.elem_nodes, p.nlev_elem, MESH[2],
                                     p.node_xy)
    part = host_embed.part_mesh(whole, p.n_owned)
    assert host_embed.part_mesh(whole, whole.n_nodes) is whole
    for name in ("node_elems", "node_elems_pos", "node_elems_num",
                 "node_edges", "node_edges_sign", "node_edges_num"):
        a, b = getattr(part, name), getattr(whole, name)
        np.testing.assert_array_equal(a[:p.n_owned], b[:p.n_owned])
        assert (a[p.n_owned:] == (0 if name.endswith("_num") else -1)).all()
    for name in ("edges", "nlev_nod", "nlev_edge", "area", "elem_nodes"):
        np.testing.assert_array_equal(getattr(part, name),
                                      getattr(whole, name))
    for bad in (0, whole.n_nodes + 1):
        with pytest.raises(ValueError, match="n_owned"):
            host_embed.part_mesh(whole, bad)


def test_the_phases_contract(case, monkeypatch, capsys):
    (elem_nodes, nlev_elem, node_xy), ref, fields = case
    monkeypatch.setenv(host_embed.DEVICE_ENV, "cpu")
    p = ranks.stripes(elem_nodes, nlev_elem, node_xy, ref.edges,
                      ranks.even_counts(ref.n_nodes, 2))[0]
    local = {k: np.ascontiguousarray(v[:, p.edges] if k == "fct_adf_h"
                                     else v[:, p.nodes])
             for k, v in fields.items()}
    # each held here while the library may read it
    held = [_buffers(local) for _ in range(2)]
    addrs, other = held[0][2], held[1][2]
    try:
        assert _setup((p.elem_nodes, p.nlev_elem, p.node_xy), MESH[2],
                      0) == 1
        assert "n_owned=0" in capsys.readouterr().err
        assert _setup((p.elem_nodes, p.nlev_elem, p.node_xy), MESH[2],
                      p.n_owned) == 0
        assert host_embed.dims() == (len(p.nodes), len(p.edges),
                                     ref.n_layers)
        assert host_embed.post_comm(*addrs) == 1
        assert "no pre_comm before it" in capsys.readouterr().err
        assert host_embed.step(*addrs[:8]) == 1
        assert "halo nodes" in capsys.readouterr().err
        assert host_embed.pre_comm(*addrs) == 0
        assert host_embed.pre_comm(*addrs) == 1
        assert "awaits its post_comm" in capsys.readouterr().err
        assert host_embed.post_comm(*other) == 1
        assert "ten buffers" in capsys.readouterr().err
        # the refused post_comm ended the pending step: a new one runs
        assert host_embed.pre_comm(*addrs) == 0
        assert host_embed.post_comm(*addrs) == 0
    finally:
        host_embed.reset()
