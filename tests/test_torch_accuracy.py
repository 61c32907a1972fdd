"""PyTorch port: the f32 drift study (``utils/accuracy.py``, the counterpart
of ``scripts/accuracy_study.py``) on the CPU, on the JAX script's inputs
(``small``, ``random_fields(seed=0)``, ``dt=0.5``, iterative FCT).

The port's plain f64 trajectory, the reference of both tables, must equal
the JAX ``FctAleSolver(backend="xla")`` f64 trajectory within relerr 1e-12.
The port's plain f32 drift row must be within a factor of 10 of the JAX
xla-f32 row: both are f32 rounding against the same f64 result, but the
two packages sum in different orders (PyTorch's and XLA's reductions and
FMA contraction), so their f32 errors differ while staying of one size.
The ``flux_eps`` table has the JAX script's five rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.config import FctAleConfig as JaxConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.mesh import random_fields as jax_random_fields
from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver as JaxSolver
from fesom2_accelerate_tpu_torch.mesh import (
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.utils import accuracy

STEPS = (1, 5)
# the f32 rows of the two packages agree within this factor either way
DRIFT_FACTOR = 10.0


@pytest.fixture(scope="module")
def small():
    return generate_planar_mesh(preset="small")


@pytest.fixture(scope="module")
def fields(small):
    return random_fields(small, seed=0, dtype=np.float64)


def _jax_trajectory(dtype, eps: float) -> dict:
    """{N: {key: float64 numpy}}: the JAX script's run(), one N-step run
    from the initial state each."""
    mesh = jax_planar_mesh(preset="small")
    cfg = JaxConfig(dt=0.5, iter_yn=True, dtype=dtype, flux_eps=eps)
    solver = JaxSolver(mesh, cfg, backend="xla")
    state = solver.init_state(jax_random_fields(mesh, seed=0,
                                                dtype=np.float64))
    return {n: {k: np.asarray(v, np.float64)
                for k, v in solver.run(state, n).items()} for n in STEPS}


@pytest.fixture(scope="module")
def jax_f64():
    return _jax_trajectory(jnp.float64, 1e-16)


def test_plain_f64_trajectory_equals_jax_xla(small, fields, jax_f64):
    ours = accuracy.trajectory(small, fields, torch.float64, 1e-16, STEPS,
                               device="cpu")
    for n in STEPS:
        for k in accuracy.DRIFT_KEYS:
            err = accuracy.relerr(ours[n][k], jax_f64[n][k])
            assert err <= 1e-12, f"N={n} {k}: relerr {err:.3e}"


def test_plain_f32_drift_is_of_the_jax_size(small, fields, jax_f64):
    jax_f32 = _jax_trajectory(jnp.float32, 1e-7)
    tables = accuracy.study(small, "cpu", STEPS)
    assert tables["backends"] == ["torch"] and tables["device"] == "cpu"
    assert [r["steps"] for r in tables["drift"]] == list(STEPS)
    for row in tables["drift"]:
        n = row["steps"]
        for k in accuracy.DRIFT_KEYS:
            ours = row["torch"][k]
            ref = accuracy.relerr(jax_f32[n][k], jax_f64[n][k])
            assert 0.0 < ours < 1e-5 and 0.0 < ref
            assert ref / DRIFT_FACTOR <= ours <= ref * DRIFT_FACTOR, (
                f"N={n} {k}: port {ours:.3e}, JAX xla {ref:.3e}")


def test_flux_eps_table_has_the_jax_rows(small, capsys):
    """The five flux_eps rows of the JAX script (1e-5 .. 1e-9), each with
    fct_plus, fct_minus and fct_LO against the f64 step; the command
    prints both tables on the CPU."""
    assert accuracy.main(["--device", "cpu", "--steps", "1"]) == 0
    out = capsys.readouterr().out
    assert "## f32 N-step drift" in out and "## b2 flux_eps" in out
    tables = accuracy.study(small, "cpu", (1,))
    assert [r["flux_eps"] for r in tables["flux_eps"]] == [
        1e-5, 1e-6, 1e-7, 1e-8, 1e-9]
    for row in tables["flux_eps"]:
        assert set(row["torch"]) == {"fct_plus", "fct_minus", "fct_LO"}
        assert all(0.0 < v < 1e-3 for v in row["torch"].values())
    # one step's fct_LO is the drift table's N = 1 at flux_eps 1e-7
    at_1e7 = tables["flux_eps"][2]["torch"]["fct_LO"]
    assert at_1e7 == tables["drift"][0]["torch"]["fct_LO"]


@pytest.mark.parametrize("call", [
    lambda m, f: accuracy.trajectory(m, f, torch.float64, 1e-16, STEPS),
    lambda m, f: accuracy.one_step(m, f, torch.float64, 1e-16)],
    ids=["trajectory", "one_step"])
def test_runs_take_no_default_device(small, fields, call):
    """The device is the caller's choice, as for ``FctAleSolver``: the
    study's runs take no default, so none runs on the CPU unasked."""
    with pytest.raises(TypeError, match="device"):
        call(small, fields)
