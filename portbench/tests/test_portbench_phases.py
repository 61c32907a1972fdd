"""The cell ``core2-4rank.fct-abi-phases.T2`` on the CPU at toy size, its
ranks processes of their own over gloo as on the cards (the harness's
``run_rank`` in each, the ABI's backend 1 a CPU solver of the plain
stages): correct; the control and a host that skips the exchange not
correct; a traced run reads both span metrics.  And the host's partition
(``portbench/ranks.py``): owned nodes and edges cover the mesh once, the
exchange lists of two ranks match, and a program without the partition's
entry points fails at set-up, before any collective."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness, inputs, ranks
from portbench.reference.mesh import build_edges, build_mesh
from portbench.tests.toy import TOY_MESH, run_toy

CELL = "core2-4rank.fct-abi-phases.T2"
# one rank of a run: the harness's run_rank, its last line on stdout
RANK = r"""
import io, json, sys
from fesom2_accelerate_tpu_torch import host_embed
from fesom2_accelerate_tpu_torch.model import FctAleSolver
from fesom2_accelerate_tpu_torch.parallel import distributed
from portbench import run
from portbench.drivers import fct_abi_phases
from portbench.tests.toy import toy_cell

rank, world, init, traced, control, exchanged = sys.argv[1:7]
host_embed._solver = lambda mesh, cfg, backend: FctAleSolver(
    mesh, cfg, device="cpu")
fct_abi_phases.Phases.exchanged = exchanged == "1"
distributed.init_distributed(init, int(world), int(rank))
line = run.run_rank(toy_cell(%r, ranks=int(world)), 2 ** 31 + 5, 0.3,
                    traced == "1", "cpu", int(rank), int(world),
                    out=io.StringIO(), control=control == "1")
print(json.dumps(line))
""" % CELL


def ranks_run(tmp_path, world=2, traced=False, control=False,
              exchanged=True):
    """Rank 0's last line of a ``world``-rank run; every rank ended with
    exit code 0 within the timeout."""
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT),
               GLOO_SOCKET_IFNAME="lo")
    init = f"file://{tmp_path}/rdv"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world), init,
         str(int(traced)), str(int(control)), str(int(exchanged))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(harness.ROOT)) for r in range(world)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return json.loads(outs[0].strip().splitlines()[-1])


def test_two_ranks_correct_and_traced(tmp_path):
    line = ranks_run(tmp_path, traced=True)
    assert line["correct"] is True
    assert line["device"]["count"] == 2
    assert set(line["metrics"]) == {"abi.pre_comm_ms", "abi.post_comm_ms"}
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("control, exchanged", [(True, True),
                                                (False, False)],
                         ids=["control", "no_exchange"])
def test_two_ranks_not_correct(tmp_path, control, exchanged):
    line = ranks_run(tmp_path, control=control, exchanged=exchanged)
    assert line["correct"] is False
    assert line["checks"]["abi_relerr"]["value"] > 1e-3


def test_one_rank_in_process(on_cpu):
    line = run_toy(CELL, ranks=1)
    assert line["correct"] is True and set(line["metrics"]) == {
        "step_ms.abi", "setup_s"}


def test_a_program_without_the_phases_fails_at_setup(on_cpu, monkeypatch):
    from fesom2_accelerate_tpu_torch import host_embed

    monkeypatch.delattr(host_embed, "setup_part")
    with pytest.raises(AttributeError, match="setup_part"):
        run_toy(CELL, ranks=1)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_the_stripes_cover_the_mesh_once(world):
    elem_nodes, nlev_elem, node_xy = inputs.planar_mesh(
        TOY_MESH["nx"], TOY_MESH["ny"], TOY_MESH["nl"])
    mesh = build_mesh(elem_nodes, nlev_elem, TOY_MESH["nl"], node_xy)
    parts = ranks.stripes(elem_nodes, nlev_elem, node_xy, mesh.edges,
                          ranks.even_counts(mesh.n_nodes, world))
    owned = np.concatenate([p.nodes[:p.n_owned] for p in parts])
    assert np.array_equal(np.sort(owned), np.arange(mesh.n_nodes))
    for p in parts:
        # every element of an owned node is local, and only those
        touch = np.isin(elem_nodes, p.nodes[:p.n_owned]).any(axis=1)
        assert len(p.elem_nodes) == touch.sum()
        # each local edge is its global edge, signed by their directions
        ends = p.nodes[build_edges(p.elem_nodes)[0]]
        assert np.array_equal(np.sort(ends, axis=1), mesh.edges[p.edges])
        assert np.array_equal(p.edge_sign,
                              np.where(ends[:, 0] < ends[:, 1], 1.0, -1.0))
        for q, cols in p.sends.items():
            got = parts[q].nodes[parts[q].recvs[p.rank]]
            assert np.array_equal(p.nodes[cols], got)
            assert (cols < p.n_owned).all()
            assert (parts[q].recvs[p.rank] >= parts[q].n_owned).all()

