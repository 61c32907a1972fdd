"""The reference against the program's plain float64 path and its numpy
oracle, at toy size on the CPU.  This test imports both; the reference
modules import nothing of the program (test_portbench_imports.py)."""

import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import build_mesh_from_elements
from fesom2_accelerate_tpu_torch.model import FctAleSolver, Stress2RhsSolver
from fesom2_accelerate_tpu_torch.ops import oracle

from portbench import inputs
from portbench.drivers.fct_resident import compared
from portbench.reference import fct
from portbench.reference.compare import relerr
from portbench.reference.mesh import build_mesh
from portbench.reference.stress2rhs import stress2rhs

RAW = inputs.planar_mesh(12, 9, 8)
REF = build_mesh(RAW[0], RAW[1], 8, RAW[2])
PORT = build_mesh_from_elements(RAW[0], RAW[1], 8, RAW[2])


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("flux_eps", [1e-16, 1e-7])
def test_fct_step_against_the_plain_path_and_the_oracle(iter_yn, flux_eps):
    f = inputs.fields(REF, 2 ** 31 + 1, 1, "cpu")[0]
    f = {k: v[0] if k in inputs.TRACER_FIELDS else v for k, v in f.items()}
    got = fct.step(fct.Masks(REF, torch.float64, "cpu"), f, dt=0.5,
                   flux_eps=flux_eps, iter_yn=iter_yn)
    cfg = FctAleConfig(dt=0.5, flux_eps=flux_eps, iter_yn=iter_yn,
                       dtype=torch.float64)
    sv = FctAleSolver(PORT, cfg, "torch", device="cpu")
    plain = sv.step(sv.init_state({k: v.numpy() for k, v in f.items()}))
    orc = oracle.fct_ale_step(PORT, {k: v.numpy() for k, v in f.items()},
                              iter_yn=iter_yn, dt=0.5, flux_eps=flux_eps)
    keys = compared(iter_yn)
    assert set(got) == set(keys)
    assert relerr(got, {k: plain[k] for k in keys}) < 1e-12
    assert relerr(got, {k: torch.as_tensor(orc[k]) for k in keys}) < 1e-12


def test_stress2rhs_against_the_plain_path_and_the_oracle():
    x = dict(inputs.evp_inputs(REF, 5, "cpu"))
    x["rhs_a"] = x["rhs_a"][1]
    order = ("elem_area", "ice_strength", "sigma11", "sigma12", "sigma22",
             "gradient_sca", "metric_factor", "inv_areamass", "rhs_a",
             "rhs_m")
    u, v = stress2rhs(REF, *(x[k] for k in order))
    pu, pv = Stress2RhsSolver(PORT, torch.float64, "torch",
                              device="cpu")(*(x[k] for k in order))
    ou, ov = oracle.stress2rhs(PORT.elem_nodes, PORT.node_elems,
                               PORT.node_elems_pos, PORT.node_elems_num,
                               *(x[k].numpy() for k in order))
    assert relerr({"u": u, "v": v}, {"u": pu, "v": pv}) < 1e-12
    want = {"u": torch.as_tensor(ou), "v": torch.as_tensor(ov)}
    assert relerr({"u": u, "v": v}, want) < 1e-12
    assert bool((u == 0).any())  # nodes without mass


def test_relerr():
    w = {"a": torch.tensor([1.0, -2.0, 4.0])}
    assert relerr({"a": np.array([1.0, -2.0, 4.0])}, w) == 0.0
    assert relerr({"a": torch.tensor([1.0, -2.0, 4.4])}, w) == \
        pytest.approx(0.1)
    assert relerr({"a": torch.tensor([1.0, float("nan"), 4.0])}, w) == \
        float("inf")
    assert relerr({"a": torch.tensor([1.0, -2.0])}, w) == float("inf")
