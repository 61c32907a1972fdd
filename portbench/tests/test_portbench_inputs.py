"""The frozen inputs and the reference's mesh: the same arrays as the
program's generator today, and fields with the structure they promise."""

import json
import pathlib

import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu_torch.mesh import PRESETS, generate_planar_mesh

from portbench import inputs
from portbench.reference.mesh import build_mesh

ROOT = pathlib.Path(__file__).resolve().parents[2]
MESH_KEYS = ("elem_nodes", "edges", "edge_tri", "nlev_elem", "nlev_nod",
             "nlev_edge", "node_elems", "node_elems_pos", "node_elems_num",
             "node_edges", "node_edges_sign", "node_edges_num", "area")


@pytest.mark.parametrize("preset", ["toy", "tiny", "small", "pi", "core2"])
def test_mesh_equals_the_programs_generator(preset):
    p = PRESETS[preset]
    elem_nodes, nlev_elem, node_xy = inputs.planar_mesh(p["nx"], p["ny"],
                                                        p["nl"])
    ref = build_mesh(elem_nodes, nlev_elem, p["nl"], node_xy)
    port = generate_planar_mesh(preset=preset)
    np.testing.assert_array_equal(node_xy, port.node_xy)
    for k in MESH_KEYS:
        np.testing.assert_array_equal(getattr(ref, k), getattr(port, k), k)


def ref_mesh(nx, ny, nl):
    elem_nodes, nlev_elem, node_xy = inputs.planar_mesh(nx, ny, nl)
    return build_mesh(elem_nodes, nlev_elem, nl, node_xy)


def test_core2_sizes_as_the_configuration_states():
    cfg = json.loads((ROOT / "portbench/configs/core2.json").read_text())
    ref = ref_mesh(**{k: cfg["mesh"][k] for k in ("nx", "ny", "nl")})
    s = cfg["sizes"]
    assert (ref.n_nodes, ref.n_elems, ref.n_edges, ref.n_layers) == (
        s["surface_nodes"], s["elements"], s["edges"], s["layers"])
    assert int((ref.nlev_nod - 1).sum()) == s["active_node_layers"]
    assert int(ref.nlev_edge.sum()) == s["active_edge_layers"]


def toy():
    return ref_mesh(12, 9, 8)


def test_fields_from_the_seed():
    mesh = toy()
    (a,) = inputs.fields(mesh, 2 ** 31 + 3, 2, "cpu")
    b, b1 = inputs.fields(mesh, 2 ** 31 + 3, 2, "cpu", sets=2)
    (c,) = inputs.fields(mesh, 2 ** 31 + 4, 2, "cpu")
    L, N, Ed = mesh.n_layers, mesh.n_nodes, mesh.n_edges
    assert set(a) == set(inputs.TRACER_FIELDS) | set(inputs.SHARED_FIELDS)
    for k in a:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
        assert a[k].dtype == torch.float64
    assert a["ttf"].shape == (2, L, N) and a["hnode"].shape == (L, N)
    assert a["fct_adf_v"].shape == (2, L + 1, N)
    assert a["fct_adf_h"].shape == (2, L, Ed)
    assert bool((a["hnode"] >= 0.5).all() & (a["hnode_new"] >= 0.5).all())
    z = torch.arange(L + 1)[:, None]
    dead = z >= torch.as_tensor(mesh.nlev_nod)[None] - 1
    assert bool((a["fct_adf_v"][:, dead] == 0).all())
    dead = z[:L] >= torch.as_tensor(mesh.nlev_edge)[None]
    assert bool((a["fct_adf_h"][:, dead] == 0).all())
    assert not torch.equal(a["ttf"][0], a["ttf"][1])
    # a later set: the fluxes and increments drawn anew, the rest shared
    assert set(b1) == set(a)
    for k in a:
        assert torch.equal(b1[k], a[k]) is (k not in inputs.STEP_FIELDS)
    assert bool((b1["fct_adf_h"][:, dead] == 0).all())


def test_evp_inputs_from_the_seed():
    mesh = toy()
    a = inputs.evp_inputs(mesh, 7, "cpu")
    b = inputs.evp_inputs(mesh, 7, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["gradient_sca"].shape == (6, mesh.n_elems)
    assert a["rhs_a"].shape == (2, mesh.n_nodes)
    assert a["rhs_m"].shape == (mesh.n_nodes,)
    assert bool((a["elem_area"] >= 0.1).all())
    # about half the elements carry ice, half the nodes mass
    assert 0.2 < float((a["ice_strength"] > 0).double().mean()) < 0.8
    rows = [a[k] for k in ("elem_area", "ice_strength", "sigma11",
                           "sigma12", "sigma22", "metric_factor",
                           "inv_areamass", "rhs_m")]
    rows += list(a["gradient_sca"]) + list(a["rhs_a"])
    assert len({float(r[0]) for r in rows}) == len(rows)
