"""PyTorch port: the whole FCT-ALE step and solver against the JAX package
and its numpy oracle, the float32 drift bound, and the rule that the port
imports no jax."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.config import FctAleConfig as JaxFctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver as JaxFctAleSolver
from fesom2_accelerate_tpu.model.fct_ale import (
    fct_ale_step as jax_fct_ale_step,
)
from fesom2_accelerate_tpu.ops import oracle
from fesom2_accelerate_tpu.ops.meshdata import build_mesh_data as jax_mesh_data
from fesom2_accelerate_tpu_torch import FctAleConfig, FctAleSolver
from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu_torch.model.fct_ale import fct_ale_step
from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data

from conftest import masked_allclose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    mesh = generate_planar_mesh(preset="small")
    jmesh = jax_planar_mesh(preset="small")
    fields = random_fields(mesh, seed=7)
    md = build_mesh_data(mesh, torch.float64, "cpu")
    jmd = jax_mesh_data(jmesh, dtype=jnp.float64)
    return mesh, jmesh, fields, md, jmd


@pytest.mark.parametrize("vlimit", [1, 2, 3])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_step_matches_oracle_and_jax(setup, vlimit, iter_yn):
    mesh, jmesh, fields, md, jmd = setup
    cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.7,
                       dtype=torch.float64)
    out = fct_ale_step(md, cfg, {k: torch.from_numpy(v)
                                 for k, v in fields.items()})
    ref = oracle.fct_ale_step(jmesh, fields, vlimit=vlimit, iter_yn=iter_yn,
                              dt=0.7)
    jcfg = JaxFctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.7,
                           dtype=jnp.float64)
    jout = jax_fct_ale_step(jmd, jcfg, {k: jnp.asarray(v)
                                        for k, v in fields.items()})
    assert out.keys() == jout.keys()
    for key, val in ref.items():
        masked_allclose(out[key].numpy(), val, msg=f"oracle[{key}]")
    for key, val in jout.items():
        masked_allclose(out[key].numpy(), np.asarray(val), msg=f"jax[{key}]")


def test_f32_path_tracks_f64(setup):
    """float32 stays within 5e-5 (relative to max(max|f64|, 1)) of float64
    on the physically meaningful outputs (tests/test_stages_xla.py)."""
    mesh, _, fields, md64, _ = setup
    md32 = build_mesh_data(mesh, torch.float32, "cpu")
    cfg64 = FctAleConfig(dt=0.7, dtype=torch.float64)
    cfg32 = FctAleConfig(dt=0.7, flux_eps=1e-7, dtype=torch.float32)
    o64 = fct_ale_step(md64, cfg64, {k: torch.from_numpy(v)
                                     for k, v in fields.items()})
    o32 = fct_ale_step(md32, cfg32, {k: torch.from_numpy(v).float()
                                     for k, v in fields.items()})
    for key in ("fct_adf_v", "fct_adf_h", "del_ttf_advvert",
                "del_ttf_advhoriz"):
        assert o32[key].dtype == torch.float32
        a = o64[key].numpy()
        b = o32[key].double().numpy()
        scale = max(np.abs(a).max(), 1.0)
        assert np.abs(a - b).max() / scale < 5e-5, key


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_run_five_iterative_steps_matches_jax_solver(setup, backend):
    """5 iterative steps of the port's solver vs the JAX solver's
    lax.scan run (backend="xla"), f64.  The cuda backend's step function
    runs here on CPU tensors, i.e. through the kernels' plain versions."""
    mesh, jmesh, fields, _, _ = setup
    n_steps = 5
    cfg = FctAleConfig(vlimit=1, iter_yn=True, dt=0.3, dtype=torch.float64)
    solver = FctAleSolver(mesh, cfg, backend="torch", device="cpu")
    if backend == "cuda":
        from fesom2_accelerate_tpu_torch.ops.cuda.step import (
            fct_ale_step_cuda,
        )
        solver._step_fn = fct_ale_step_cuda
    state = solver.init_state(fields)
    out = solver.run(state, n_steps)
    assert out.keys() == state.keys()

    jcfg = JaxFctAleConfig(vlimit=1, iter_yn=True, dt=0.3,
                           dtype=jnp.float64)
    jsolver = JaxFctAleSolver(jmesh, jcfg, backend="xla")
    jout = jsolver.run(jsolver.init_state(fields), n_steps)
    for key in ("fct_LO", "fct_adf_v", "fct_adf_h"):
        masked_allclose(out[key].numpy(), np.asarray(jout[key]), rtol=1e-10,
                        atol=1e-11, msg=f"{key} after {n_steps} steps")


def test_solver_state_dtype_and_device(setup):
    mesh, _, fields, _, _ = setup
    solver = FctAleSolver(mesh, FctAleConfig(dtype=torch.float32),
                          device="cpu")
    state = solver.init_state(fields)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in state.values())
    out = solver.step(state)
    assert {"fct_ttf_max", "fct_ttf_min", "fct_plus",
            "fct_minus"} <= out.keys()


def test_cuda_backend_needs_cuda_device():
    mesh = generate_planar_mesh(preset="tiny")
    with pytest.raises(ValueError, match="CUDA device"):
        FctAleSolver(mesh, FctAleConfig(), backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        FctAleSolver(mesh, FctAleConfig(), backend="pallas", device="cpu")


def test_config_checks():
    with pytest.raises(ValueError, match="vlimit"):
        FctAleConfig(vlimit=4)
    with pytest.raises(ValueError, match="dtype"):
        FctAleConfig(dtype=torch.float16)
    assert FctAleConfig(dtype=torch.float64).np_dtype == np.float64


def test_port_imports_no_jax():
    """With jax and the JAX package made unimportable, the port imports
    (the stress2rhs solver, the mesh ordering and file reader, the byte
    models, the partitioner, the sharded solver, the timing helpers and
    the tuning harness included), runs one toy FCT step, one toy
    stress2rhs call, one sharded toy step on two parts, and the tuner's
    validation of a2 and of the K12 -> K3 -> K4 step."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fesom2_accelerate_tpu'] = None\n"
        "import torch\n"
        "import fesom2_accelerate_tpu_torch as f\n"
        "from fesom2_accelerate_tpu_torch.mesh import random_fields\n"
        "import fesom2_accelerate_tpu_torch.ops.cuda.kernels\n"
        "import fesom2_accelerate_tpu_torch.ops.cuda.build\n"
        "mesh = f.generate_planar_mesh(preset='toy')\n"
        "s = f.FctAleSolver(mesh, f.FctAleConfig(), backend='torch',\n"
        "                   device='cpu')\n"
        "out = s.step(s.init_state(random_fields(mesh, seed=0)))\n"
        "assert bool(torch.isfinite(out['del_ttf_advhoriz']).all())\n"
        "import fesom2_accelerate_tpu_torch.model.stress2rhs\n"
        "import fesom2_accelerate_tpu_torch.mesh.ordering\n"
        "import fesom2_accelerate_tpu_torch.mesh.fesom_io\n"
        "from fesom2_accelerate_tpu_torch.runtime import profiling\n"
        "assert profiling.stress2rhs_bytes(mesh) > 0\n"
        "E, N = mesh.n_elems, mesh.n_nodes\n"
        "e, n = torch.ones(E), torch.ones(N)\n"
        "s2r = f.Stress2RhsSolver(mesh, torch.float32, backend='torch',\n"
        "                         device='cpu')\n"
        "U, V = s2r(e, e, e, e, e, torch.ones(6, E), e, n, n, n)\n"
        "assert U.shape == (N,) and bool(torch.isfinite(V).all())\n"
        "import fesom2_accelerate_tpu_torch.parallel.partition\n"
        "import fesom2_accelerate_tpu_torch.parallel.step_sharded\n"
        "sh = f.ShardedFctAleSolver(mesh, f.FctAleConfig(),\n"
        "                           devices=['cpu'] * 2)\n"
        "st = sh.step(sh.init_state(random_fields(mesh, seed=0)))\n"
        "assert sh.gather_node(st['del_ttf_advhoriz']).shape[-1] == N\n"
        "assert f.partition_mesh(mesh, 2).n_parts == 2\n"
        "import fesom2_accelerate_tpu_torch.runtime.tracing\n"
        "from fesom2_accelerate_tpu_torch.utils import tune, tuning\n"
        "assert tuning.check_a2(tuning.a2_case(mesh, 'cpu'), 128) < 1e-5\n"
        "assert tuning.check_step(tuning.fct_case(mesh, 'cpu'), True,\n"
        "                         False, 128) < 1e-4\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'jaxlib')\n"
        "            and sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
