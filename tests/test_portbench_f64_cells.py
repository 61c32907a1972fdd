"""The benchmark's configuration ``core2-f64`` (FESOM2 at its own double
precision) and its cells ``core2-f64.fct-resident-wp.T2`` and
``core2-f64.fct-abi-wp.T2``, on the CPU at toy size, where the program's
kernel wrappers run their plain versions (``portbench/tests/conftest.py``'s
``on_cpu``):

* each cell runs correct, untraced and traced;
* the same drivers with the configuration set to float32 and
  ``flux_eps`` 1e-7 (the f32 program: backend 1 through the ABI) read not
  correct, and so does the bfloat16 control: the cells' limits catch a
  lower precision;
* the drivers serve the configuration's dtype: the resident solver's
  state, the ABI's backend (2 for float64, 1 for float32, any other
  refused, as is a ``flux_eps`` that backend does not run), the contract
  bytes at the kernels' itemsize, and ``abi.bytes_cast`` 0 in float64;
* ``contract.fct_step_bytes`` at itemsize 8 against a count made field by
  field and layer by layer on the toy mesh;
* the reader of ``kernels_roofline.abi`` on a synthetic trace.
"""

import io

import pytest
import torch

from fesom2_accelerate_tpu_torch.runtime import tracing

from portbench import contract, harness, inputs, run
from portbench.drivers import fct_abi_wp, fct_resident_wp
from portbench.reference.mesh import build_mesh
from portbench.tests.conftest import on_cpu  # noqa: F401 (a fixture)
from portbench.tests.toy import TOY_MESH, run_toy, toy_cell

CELLS = ["core2-f64.fct-resident-wp.T2", "core2-f64.fct-abi-wp.T2"]
SEED = 2 ** 31 + 29
F32 = {"dtype": "float32", "dt": 0.5, "flux_eps": 1e-7, "vlimit": 1,
       "iter_yn": False}


def _fct(**kw) -> dict:
    return dict(harness.cell(CELLS[0]).config["fct"], **kw)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_correct_at_toy_size(on_cpu, name, traced):
    line = run_toy(name, traced=traced, seed=SEED)
    c = toy_cell(name)
    assert line["correct"] is True and line["attempted"] >= 1
    wanted = c.per_layer if traced else c.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    if not traced:
        assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    for chk in line["checks"].values():
        assert chk["value"] <= chk["limit"]


@pytest.mark.parametrize("control", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", CELLS)
def test_a_lower_precision_reads_not_correct(on_cpu, name, control):
    line = (run_toy(name, seed=SEED, control=True) if control
            else run_toy(name, seed=SEED, fct=F32))
    assert line["correct"] is False
    assert all(chk["value"] > chk["limit"]
               for chk in line["checks"].values()), line["checks"]


def _ctx(name: str, **config):
    c = toy_cell(name, **config)
    return harness.Ctx(c, SEED, "cpu", out=io.StringIO())


@pytest.mark.parametrize("fct, dtype, itemsize", [
    ({}, torch.float64, 8), (F32, torch.float32, 4)])
def test_the_resident_driver_serves_the_configured_dtype(on_cpu, fct, dtype,
                                                         itemsize):
    prog = fct_resident_wp.setup(_ctx(CELLS[0], **({"fct": fct} if fct
                                                   else {})))
    assert all(v.dtype == dtype for s in prog.given for v in s.values())
    assert all(v.dtype == dtype for v in prog.state.values())
    assert prog.bytes_per_step == contract.fct_step_bytes(prog.ref_mesh, 2,
                                                          itemsize)
    assert all(v <= lim for _, v, lim in prog.checks()) == (itemsize == 8)


@pytest.mark.parametrize("dtype, backend", [("float64", 2),
                                            ("float32", 1)])
def test_the_abi_driver_takes_the_backend_of_the_dtype(on_cpu, monkeypatch,
                                                       dtype, backend):
    from fesom2_accelerate_tpu_torch import host_embed

    asked = []
    setup = host_embed.setup
    monkeypatch.setattr(host_embed, "setup",
                        lambda *a: asked.append(a[-1]) or setup(*a))
    tracing.reset_counters()
    fct = _fct() if dtype == "float64" else F32
    prog = fct_abi_wp.setup(_ctx(CELLS[1], fct=fct))
    try:
        assert asked == [backend]
        assert host_embed.session().cfg.dtype == getattr(torch, dtype)
        c = tracing.counters()
        moved = c.get("abi.bytes_registered", 0) + c["abi.bytes_pageable"]
        assert c.get("abi.bytes_cast", 0) == (0 if backend == 2 else moved)
        assert prog.bytes_per_step == contract.fct_step_bytes(
            prog.ref_mesh, 2, 8 if backend == 2 else 4)
    finally:
        host_embed.reset()


@pytest.mark.parametrize("fct, match", [
    ({"flux_eps": 1e-7}, "backend 2 runs flux_eps=1e-16"),
    ({"iter_yn": True}, "non-iterative"),
    ({"dtype": "bfloat16"}, "no ABI backend runs the kernels in bfloat16"),
    ({"dtype": "float16", "flux_eps": 1e-7},
     "no ABI backend runs the kernels in float16")])
def test_the_abi_driver_refuses_what_no_backend_runs(on_cpu, fct, match):
    with pytest.raises(ValueError, match=match):
        fct_abi_wp.setup(_ctx(CELLS[1], fct=_fct(**fct)))


def test_dtype_names_a_float_dtype():
    assert fct_resident_wp.dtype_of({"dtype": "float64"}) == torch.float64
    for bad in ("int32", "double_", "Tensor"):
        with pytest.raises(ValueError, match="names no float dtype"):
            fct_resident_wp.dtype_of({"dtype": bad})


def test_contract_bytes_at_itemsize_8_by_hand():
    """Every array a toy step's contract moves, counted entry by entry:
    the int32 connectivity, then each f64 field on its active layers."""
    nl = TOY_MESH["nl"]
    elem_nodes, nlev_elem, node_xy = inputs.planar_mesh(
        TOY_MESH["nx"], TOY_MESH["ny"], nl)
    m = build_mesh(elem_nodes, nlev_elem, nl, node_xy)
    L = m.n_layers
    node = sum(1 for n in range(m.n_nodes) for z in range(L)
               if z < m.nlev_nod[n] - 1)
    edge = sum(1 for e in range(m.n_edges) for z in range(L)
               if z < m.nlev_edge[e])
    ints = 4 * (2 * m.n_edges + m.n_edges + m.n_nodes)  # ends, levels
    shared = ["hnode", "hnode_new", "area"]
    reads = {"ttf": node, "fct_LO": node, "fct_adf_v": node,
             "fct_adf_h": edge, "del_ttf_advvert": node,
             "del_ttf_advhoriz": node}
    writes = {"fct_adf_v": node, "fct_adf_h": edge, "del_ttf_advvert": node,
              "del_ttf_advhoriz": node}
    tracers = 2
    entries = (len(shared) * node
               + tracers * (sum(reads.values()) + sum(writes.values())))
    assert 0 < node < L * m.n_nodes and 0 < edge < L * m.n_edges
    assert contract.fct_step_bytes(m, tracers, 8) == ints + 8 * entries
    assert contract.fct_step_bytes(m, tracers, 8) - ints == 2 * (
        contract.fct_step_bytes(m, tracers, 4) - ints)


def _read(rec):
    return harness.load_module(
        harness.HERE / "metrics" / "kernels_roofline.abi.py").read(rec)


def test_kernels_roofline_abi_counts_only_the_kernels():
    """Two steps in 1 ms of device time: 0.3 ms of a kernel overlapping
    another of 0.2 ms (0.4 ms of union), the copies and a memset left
    out."""
    ops = [("Memcpy HtoD (Pinned -> Device)", 0.0, 500.0, 7),
           ("void limit_kernel<double>", 500.0, 800.0, 7),
           ("void b3h_kernel<double>", 700.0, 900.0, 7),
           ("Memset (Device)", 900.0, 950.0, 7),
           ("Memcpy DtoH (Device -> Pinned)", 950.0, 1000.0, 8)]
    rec = harness.Record([{"trace": {"ops": ops, "steps": 2},
                           "spans": []}], 1.0, 10 ** 9)
    want = 100.0 * 2e9 / 400e-6 / contract.PEAK_BYTES_PER_S
    assert _read(rec) == pytest.approx(want)
    assert _read(harness.Record(rec.ranks, 1.0, None)) is None
    only_copies = [o for o in ops if o[0].startswith(("Memcpy", "Memset"))]
    assert _read(harness.Record([{"trace": {"ops": only_copies,
                                            "steps": 2}}], 1.0, 1)) is None
    assert _read(harness.Record([{"trace": None}], 1.0, 1)) is None


def test_run_line_of_the_abi_cell_traced_on_the_cpu(on_cpu):
    """A traced run on the CPU ran no device operation: the reader reads
    nothing and the line leaves the metric out."""
    c = toy_cell(CELLS[1])
    line = run.run_rank(c, SEED, 0.2, True, "cpu", out=io.StringIO())
    assert line["correct"] is True
    assert "kernels_roofline.abi" not in line["metrics"]
