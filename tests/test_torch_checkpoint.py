"""PyTorch port: checkpoints (``runtime/checkpoint.py``) against the JAX
package's ``runtime/checkpoint.py``.

* ``mesh_fingerprint`` gives the JAX function's digits on planar,
  cylinder and FESOM2-file meshes;
* npz checkpoints cross between the packages both ways, with the same
  ``meta.json``; an Orbax checkpoint of the JAX package makes the port
  raise a RuntimeError that says so;
* another mesh, vlimit or iter_yn raises;
* ``ShardedFctAleSolver.save_checkpoint`` at 4 parts, loaded at 2 parts
  and on one device, resumes: 2 + 3 steps equal 5 uninterrupted steps and
  the JAX sharded ``run``, float64 at 1e-12;
* a 3-tracer state round-trips, and another tracer count raises.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.config import FctAleConfig as JaxFctAleConfig
from fesom2_accelerate_tpu.mesh import fesom_io as jax_fesom_io
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.mesh.generate import (
    generate_cylinder_mesh as jax_cylinder_mesh,
)
from fesom2_accelerate_tpu.parallel import (
    ShardedFctAleSolver as JaxShardedFctAleSolver,
)
from fesom2_accelerate_tpu.runtime import checkpoint as jax_ckpt
from fesom2_accelerate_tpu_torch import (
    FctAleConfig,
    FctAleSolver,
    ShardedFctAleSolver,
)
from fesom2_accelerate_tpu_torch.mesh import (
    generate_cylinder_mesh,
    generate_planar_mesh,
    random_fields,
    read_fesom_mesh,
)
from fesom2_accelerate_tpu_torch.ops.cuda.step import BATCH_SHARED
from fesom2_accelerate_tpu_torch.runtime import checkpoint as ckpt

from conftest import masked_allclose

POLAR_CAP = os.path.join(os.path.dirname(__file__), "data", "polar_cap")

MESHES = {
    "planar": (lambda: generate_planar_mesh(preset="small"),
               lambda: jax_planar_mesh(preset="small")),
    "cylinder": (lambda: generate_cylinder_mesh(48, 16, 8)[0],
                 lambda: jax_cylinder_mesh(48, 16, 8)[0]),
    "polar_cap": (lambda: read_fesom_mesh(POLAR_CAP)[0],
                  lambda: jax_fesom_io.read_fesom_mesh(POLAR_CAP)[0]),
}


@pytest.fixture(scope="module")
def small():
    mesh = generate_planar_mesh(preset="small")
    return mesh, jax_planar_mesh(preset="small"), random_fields(mesh, seed=4)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_fingerprint_equals_jax(name):
    ours, ref = (make() for make in MESHES[name])
    fp = ckpt.mesh_fingerprint(ours)
    assert len(fp) == 16 and int(fp, 16) >= 0
    assert fp == jax_ckpt.mesh_fingerprint(ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_port_save_loads_in_jax(tmp_path, small, dtype):
    mesh, jmesh, fields = small
    cfg = FctAleConfig(dt=0.4, vlimit=2, iter_yn=True, dtype=dtype)
    solver = FctAleSolver(mesh, cfg, device="cpu")
    state = solver.run(solver.init_state(fields), 2)
    ckpt.save_checkpoint(tmp_path / "ck", state, mesh, cfg, step=2)

    jcfg = JaxFctAleConfig(dt=0.4, vlimit=2, iter_yn=True,
                           dtype=jnp.float64 if dtype == torch.float64
                           else jnp.float32)
    got, step = jax_ckpt.load_checkpoint(tmp_path / "ck", jmesh, jcfg)
    assert step == 2 and got.keys() == state.keys()
    for k, v in state.items():
        assert got[k].dtype == v.numpy().dtype
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)

    # the same meta as the JAX module writes for an npz checkpoint
    jax_ckpt.save_checkpoint(tmp_path / "jck", got, jmesh, jcfg, step=2,
                             use_orbax=False)
    meta, jmeta = (json.loads((tmp_path / d / "meta.json").read_text())
                   for d in ("ck", "jck"))
    assert meta == jmeta
    assert meta["dtype"] == ("float64" if dtype == torch.float64
                             else "float32")


def test_jax_npz_save_loads_in_port(tmp_path, small):
    mesh, jmesh, fields = small
    jcfg = JaxFctAleConfig(dt=0.6, dtype=jnp.float64)
    jsh = JaxShardedFctAleSolver(jmesh, jcfg, devices=jax.devices()[:2])
    jstate = jsh.run(jsh.init_state(fields), 2)
    jsh.save_checkpoint(tmp_path / "ck", jstate, step=2, use_orbax=False)
    want = jsh.gather_state(jstate)

    cfg = FctAleConfig(dt=0.6, dtype=torch.float64)
    got, step = ckpt.load_checkpoint(tmp_path / "ck", mesh, cfg)
    assert step == 2 and got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # and through the sharded solver, at another partition
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 4)
    st, step = sh.load_checkpoint(tmp_path / "ck")
    assert step == 2
    back = sh.gather_state(st)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_jax_orbax_save_raises_in_port(tmp_path, small):
    mesh, jmesh, fields = small
    jcfg = JaxFctAleConfig(dtype=jnp.float64)
    state = {k: np.asarray(v) for k, v in fields.items()}
    jax_ckpt.save_checkpoint(tmp_path / "ck", state, jmesh, jcfg,
                             use_orbax=True)
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["format"] == "orbax"
    with pytest.raises(RuntimeError, match="orbax.*npz"):
        ckpt.load_checkpoint(tmp_path / "ck", mesh,
                             FctAleConfig(dtype=torch.float64))


@pytest.mark.parametrize("change", ["mesh", "vlimit", "iter_yn"])
def test_mismatch_raises(tmp_path, small, change):
    mesh, _, fields = small
    cfg = FctAleConfig(dtype=torch.float64)
    ckpt.save_checkpoint(tmp_path / "ck", fields, mesh, cfg, step=1)
    other, ocfg = mesh, cfg
    if change == "mesh":
        other = generate_planar_mesh(preset="tiny")
    elif change == "vlimit":
        ocfg = FctAleConfig(vlimit=3, dtype=torch.float64)
    else:
        ocfg = FctAleConfig(iter_yn=True, dtype=torch.float64)
    with pytest.raises(ValueError, match="mismatch|mesh"):
        ckpt.load_checkpoint(tmp_path / "ck", other, ocfg)
    with pytest.raises(ValueError, match="mismatch|mesh"):
        ShardedFctAleSolver(other, ocfg, devices=["cpu"] * 2)\
            .load_checkpoint(tmp_path / "ck")


@pytest.mark.parametrize("iter_yn", [False, True])
def test_sharded_resume_at_other_partitions(tmp_path, small, iter_yn):
    mesh, jmesh, fields = small
    cfg = FctAleConfig(dt=0.6, iter_yn=iter_yn, dtype=torch.float64)
    sh4 = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 4)
    full = sh4.gather_state(sh4.run(sh4.init_state(fields), 5))
    sh4.save_checkpoint(tmp_path / "ck", sh4.run(sh4.init_state(fields), 2),
                        step=2)

    jcfg = JaxFctAleConfig(dt=0.6, iter_yn=iter_yn, dtype=jnp.float64)
    jsh = JaxShardedFctAleSolver(jmesh, jcfg, devices=jax.devices()[:4])
    ref = jsh.gather_state(jsh.run(jsh.init_state(fields), 5))

    sh2 = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2)
    st, step = sh2.load_checkpoint(tmp_path / "ck")
    assert step == 2
    resumed = {"2 parts": sh2.gather_state(sh2.run(st, 3))}
    one = FctAleSolver(mesh, cfg, device="cpu")
    st, step = ckpt.load_checkpoint(tmp_path / "ck", mesh, cfg)
    assert step == 2
    resumed["one device"] = {k: v.numpy() for k, v in
                             one.run(one.init_state(st), 3).items()}
    for where, got in resumed.items():
        assert got.keys() == full.keys() == ref.keys()
        for k in full:
            masked_allclose(got[k], full[k], msg=f"{where} vs 5 steps[{k}]")
            masked_allclose(got[k], ref[k], msg=f"{where} vs jax[{k}]")


def test_tracer_round_trip_and_tracer_count(tmp_path, small):
    mesh, _, fields = small
    Tb = 3
    batched = {k: v if k in BATCH_SHARED
               else np.stack([v * (1.0 + 0.1 * t) for t in range(Tb)])
               for k, v in fields.items()}
    cfg = FctAleConfig(dtype=torch.float64)
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 4)
    sh.tracers = Tb  # the CUDA backend's tracer count (its solver needs a
    # card); state movement and checkpoints are the same code
    sh.save_checkpoint(tmp_path / "ck", sh.init_state(batched), step=7)
    raw, _ = ckpt.load_checkpoint(tmp_path / "ck", mesh, cfg)
    assert raw["ttf"].shape == (Tb, mesh.n_layers, mesh.n_nodes)
    assert raw["hnode"].shape == (mesh.n_layers, mesh.n_nodes)

    sh2 = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2)
    sh2.tracers = Tb
    st, step = sh2.load_checkpoint(tmp_path / "ck")
    assert step == 7 and st["ttf"][0].shape[0] == Tb
    for k, v in sh2.gather_state(st).items():
        np.testing.assert_array_equal(v, batched[k], err_msg=k)

    for tb in (1, 2):
        sh2.tracers = tb
        with pytest.raises(ValueError, match="tracers"):
            sh2.load_checkpoint(tmp_path / "ck")
    sh2.tracers = Tb
    ckpt.save_checkpoint(tmp_path / "one", fields, mesh, cfg)
    with pytest.raises(ValueError, match="tracers"):
        sh2.load_checkpoint(tmp_path / "one")
