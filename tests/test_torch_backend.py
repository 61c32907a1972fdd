"""PyTorch port: every solver's default backend follows the devices it is
given.

``resolve_backend`` is a pure function of the devices the caller names: a
CUDA ``torch.device`` is only a name until a tensor is made on it, so the
resolution is tested here without a card.  A solver built on the CPU with
no ``backend`` runs the plain PyTorch path: bit for bit what
``backend="torch"`` gives, and within 1e-12 of the JAX package (float64),
as the existing tests hold ``backend="torch"``.  On a CUDA device the
default runs the kernels; ``python3 chip_smoke.py`` checks that by launch
counts on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.config import FctAleConfig as JaxFctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver as JaxFctAleSolver
from fesom2_accelerate_tpu.model.stress2rhs import (
    Stress2RhsSolver as JaxStress2RhsSolver,
)
from fesom2_accelerate_tpu_torch import (
    FctAleConfig,
    FctAleSolver,
    ShardedFctAleSolver,
    Stress2RhsSolver,
)
from fesom2_accelerate_tpu_torch.config import resolve_backend
from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu_torch.ops.cuda import build, kernels

from conftest import masked_allclose


@pytest.mark.parametrize("backend, devices, want", [
    (None, "cpu", "torch"),
    (None, torch.device("cpu"), "torch"),
    (None, torch.device("cuda"), "cuda"),
    (None, "cuda:1", "cuda"),
    (None, ["cuda:0"] * 4, "cuda"),
    (None, ["cpu"] * 8, "torch"),
    ("torch", "cuda", "torch"),
    ("torch", ["cpu", "cuda:0"], "torch"),
    ("cuda", ["cuda:0", "cuda:1"], "cuda"),
])
def test_resolve_backend_follows_devices(backend, devices, want):
    assert resolve_backend(backend, devices) == want


@pytest.mark.parametrize("backend, devices, match", [
    (None, ["cpu", "cuda:0"], "all CUDA or all CPU"),
    (None, "meta", "all CUDA or all CPU"),
    ("cuda", "cpu", "CUDA devices"),
    ("cuda", ["cuda:0", "cpu"], "CUDA devices"),
    ("xla", "cpu", "backend must be"),
])
def test_resolve_backend_refuses(backend, devices, match):
    with pytest.raises(ValueError, match=match):
        resolve_backend(backend, devices)


def test_solvers_refuse_mixed_devices_by_default():
    """A mix of CPU and CUDA devices raises before any tensor is made (no
    card is needed to see it), and so does a device that is neither."""
    mesh = generate_planar_mesh(preset="toy")
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ShardedFctAleSolver(mesh, FctAleConfig(), devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        FctAleSolver(mesh, FctAleConfig(), device="meta")
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        Stress2RhsSolver(mesh, torch.float32, device="meta")


@pytest.fixture(scope="module")
def small():
    mesh = generate_planar_mesh(preset="small")
    return mesh, jax_planar_mesh(preset="small"), random_fields(mesh, seed=6)


def _assert_equal_states(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("iter_yn", [False, True])
def test_fct_solver_default_on_cpu_is_torch(small, iter_yn):
    """FctAleSolver(device="cpu") with no backend: "torch", the bits of
    backend="torch" over 3 steps, within 1e-12 of the JAX solver's xla
    run, and no kernel library built."""
    mesh, jmesh, fields = small
    cfg = FctAleConfig(vlimit=2, iter_yn=iter_yn, dt=0.4,
                       dtype=torch.float64)
    solver = FctAleSolver(mesh, cfg, device="cpu")
    plain = FctAleSolver(mesh, cfg, backend="torch", device="cpu")
    assert solver.backend == "torch"
    kernels.reset_launch_counts()
    out = solver.run(solver.init_state(fields), 3)
    _assert_equal_states(out, plain.run(plain.init_state(fields), 3))
    assert sum(kernels.launch_counts().values()) == 0
    assert build.library.cache_info().currsize == 0

    jcfg = JaxFctAleConfig(vlimit=2, iter_yn=iter_yn, dt=0.4,
                           dtype=jnp.float64)
    jsolver = JaxFctAleSolver(jmesh, jcfg, backend="xla")
    jout = jsolver.run(jsolver.init_state(fields), 3)
    for k in out:
        masked_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=1e-10,
                        atol=1e-11, msg=f"jax[{k}]")


def test_stress2rhs_solver_default_on_cpu_is_torch(small):
    """Stress2RhsSolver(device="cpu") with no backend: "torch", the bits of
    backend="torch", within 1e-12 of the JAX solver's xla form."""
    mesh, jmesh, _ = small
    rng = np.random.default_rng(7)
    E, N = mesh.n_elems, mesh.n_nodes
    host = (np.abs(rng.standard_normal(E)) + 0.1, rng.standard_normal(E),
            *rng.standard_normal((3, E)), rng.standard_normal((6, E)),
            rng.standard_normal(E), rng.standard_normal(N),
            *rng.standard_normal((2, N)))
    solver = Stress2RhsSolver(mesh, torch.float64, device="cpu")
    assert solver.backend == "torch"
    got = solver(*host)
    want = Stress2RhsSolver(mesh, torch.float64, backend="torch",
                            device="cpu")(*host)
    jgot = JaxStress2RhsSolver(jmesh, dtype=jnp.float64,
                               backend="xla")(*host)
    for g, w, j, name in zip(got, want, jgot, "UV"):
        assert torch.equal(g, w), name
        masked_allclose(g.numpy(), np.asarray(j), msg=f"jax {name}")


def test_sharded_solver_default_on_cpu_is_torch(small):
    """ShardedFctAleSolver(devices=["cpu"] * 4) with no backend: "torch",
    the bits of backend="torch" over 2 steps, and within 1e-12 of the
    single-device default run."""
    mesh, _, fields = small
    cfg = FctAleConfig(dt=0.7, dtype=torch.float64)
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 4)
    plain = ShardedFctAleSolver(mesh, cfg, backend="torch",
                                devices=["cpu"] * 4)
    assert sh.backend == "torch" and sh.owned is None
    out = sh.gather_state(sh.run(sh.init_state(fields), 2))
    want = plain.gather_state(plain.run(plain.init_state(fields), 2))
    assert out.keys() == want.keys()
    single = FctAleSolver(mesh, cfg, device="cpu")
    ref = single.run(single.init_state(fields), 2)
    for k in out:
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)
        masked_allclose(out[k], ref[k].numpy(), msg=f"single[{k}]")
